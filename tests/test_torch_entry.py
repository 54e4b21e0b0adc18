"""The port's entry points (``topo4d_tpu_torch/entry.py``) against
the JAX package's ``__graft_entry__.py`` on the CPU: ``entry``'s loss
against JAX's photometric loss of the same view (JAX's tiled renderer,
which the Pallas blend equals within rounding), rtol 1e-5; and
``dryrun_multichip(2, "cpu")`` in one spawned gloo world, whose batched
steps' losses equal the port's unsharded batched step and JAX's
``make_batched_geometry_step`` without a mesh on the same inputs, rtol
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.losses.image import photometric_loss as j_photometric_loss
from topo4d_tpu.rasterizer.tiled import render_gaussians_tiled as j_render_tiled
from topo4d_tpu.testing import make_head_fixture as j_head_fixture

from topo4d_tpu_torch.entry import dryrun_inputs, dryrun_multichip, entry

CPU = "cpu"


def test_entry_loss_matches_jax():
    fn, (params, gt) = entry(CPU)
    assert params["means3D"].shape == (8280, 3) and gt.shape == (3, 512, 375)
    loss = fn(params, gt)
    assert loss.shape == () and torch.isfinite(loss)
    params_np, cams, _ = j_head_fixture()
    cam0 = cams[0]
    want = jax.jit(lambda p, g: j_photometric_loss(j_render_tiled(j_activate(p), cam0, max_span=2).image, g))(
        {k: jnp.asarray(v) for k, v in params_np.items()}, jnp.zeros((3, 512, 375), jnp.float32)
    )
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    # the parameters are the JAX fixture's
    for k, v in params_np.items():
        np.testing.assert_array_equal(params[k].numpy(), v)


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)


def _jax_batched_loss(num_views):
    """JAX's batched step of ``__graft_entry__.py``'s dryrun without a mesh
    (its tiled renderer) -> its loss."""
    from topo4d_tpu.core.quaternion import quat_normalize
    from topo4d_tpu.losses.flatten import (
        build_dihedral_quadruples,
        build_fused_flatten,
        build_umbrella_flatten,
        dihedral_cos,
    )
    from topo4d_tpu.losses.temporal import make_temporal_priors
    from topo4d_tpu.opt.adam import adam_init
    from topo4d_tpu.opt.constraints import ScatterConstraint
    from topo4d_tpu.opt.step import HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS, GeometryPriors, TrainState
    from topo4d_tpu.parallel.batched import make_batched_geometry_step
    from topo4d_tpu.topology.adjacency import build_one_ring, triangulate_faces

    params_np, cams, (verts, faces) = j_head_fixture(rows=12, cols=12, num_views=num_views, width=64, height=48)
    n = verts.shape[0]
    params = {k: jnp.asarray(v) for k, v in params_np.items()}
    ring = build_one_ring(verts, faces)
    quads = build_dihedral_quadruples(np.asarray(triangulate_faces(faces)))
    umb = build_umbrella_flatten(ring.ragged, n)
    quadruples = {k: quads for k in ("flat", "flat_lip_bottom", "flat_lip", "flat_mouth", "flat_lid_top",
                                     "flat_lid_bottom")}
    umbrellas = {k: umb for k in ("flat_eye", "flat_lip_socket", "flat_face_bottom")}
    step = make_batched_geometry_step(quadruples, umbrellas,
                                      lambda rv, cam: j_render_tiled(rv, cam, max_span=4, capacity=128))
    nbr = jnp.asarray(np.ascontiguousarray(np.asarray(ring.indices).T))
    w = jnp.asarray(np.ascontiguousarray(np.asarray(ring.weight).T))
    fused = build_fused_flatten(quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    priors = GeometryPriors(
        neighbor_indices=nbr, neighbor_dist=jnp.asarray(np.ascontiguousarray(np.asarray(ring.dist).T)), iso_w=w,
        rig_w=w, rot_w=w, init_scale=jnp.full((n,), 0.05),
        temporal=make_temporal_priors(params["means3D"], quat_normalize(params["unnorm_rotations"]), nbr),
        cos_init=dihedral_cos(params["means3D"], fused.quads)[fused.num_hard:],
    )
    state = TrainState(params=params, opt=adam_init(params), max_2d_radius=jnp.zeros(n))
    inp = dryrun_inputs(num_views, CPU)
    weights = {k: jnp.asarray(v, jnp.float32) for k, v in inp["weights"].items()}
    constraints = [ScatterConstraint(param="means3D", idx=np.arange(8, dtype=np.int32), value=params["means3D"][:8])]
    lr = {k: jnp.asarray(1e-4, jnp.float32) for k in params}
    _, _, m = step(state, jnp.asarray(inp["images"].numpy()), cams, priors, constraints, lr, weights, "track")
    return float(m["loss_total"])


def test_dryrun_multichip_two_ranks_matches_the_unsharded_step(capsys):
    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.rasterizer.render import render_gaussians

    out = dryrun_multichip(2, CPU)
    assert set(out) >= {"tiled_step", "kernel_step", "tile_sharded_render", "dense_step", "dense_tile_sharded_step",
                        "dense_single_rank_step", "sharded_bake_sum"}
    assert all(np.isfinite(v) for v in out.values())
    assert out["dense_step_overflow"] > 0
    # parts 5 and 6: the sharded results equal one rank's (the bake bit for bit inside the world)
    assert abs(out["dense_tile_sharded_step"] - out["dense_single_rank_step"]) <= 1e-6 * abs(out["dense_single_rank_step"])
    # the port's unsharded batched step on the same inputs, and JAX's
    inp = dryrun_inputs(2, CPU)
    step = make_batched_geometry_step(inp["quadruples"], inp["umbrellas"],
                                      lambda rv, cam: render_gaussians(rv, cam, max_span=4), inp["num_vertices"],
                                      device=CPU)
    _, _, m = step(inp["state"], inp["images"], inp["cams"], inp["priors"], inp["constraints"], inp["lr"],
                   inp["weights"], "track")
    unsharded = float(m["loss_total"])
    np.testing.assert_allclose(out["kernel_step"], unsharded, rtol=1e-4)
    np.testing.assert_allclose(out["tiled_step"], unsharded, rtol=1e-4)
    np.testing.assert_allclose(out["kernel_step"], _jax_batched_loss(2), rtol=1e-4)
