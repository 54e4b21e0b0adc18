"""The per-frame export, checkpoints and ``Trainer.run`` of the PyTorch port
against the JAX package on the CPU.

- ``exported_vertices`` (normal offset, inverse global transform) at rtol
  1e-5 / atol 1e-6, frame 1 (no offset) and frame 2;
- the OBJ writer byte for byte; the PNG writer through PIL's decoder;
- ``write_texture`` (K6's plain version on the CPU) against JAX's with its
  ``"pallas"`` (interpret mode) and ``"xla"`` bakes, on the decoded pixels. Bytes
  are ``(canvas * 255)`` truncated, so a color one ulp apart at an integer
  boundary moves a byte by 1: allowed on at most 0.1% of the bytes. Apart
  from that, the only pixels that differ are the cracks JAX's CPU
  evaluation leaves on exact shared edges (0 there, covered by the port and
  the C++ scanline oracle; ``tests/test_torch_bake.py``);
- ``Trainer.run`` on the ``tests/test_pipeline.py:30`` setup against the
  JAX trainer's run: per-frame outputs, byte-identical topology across
  frames, ``params.npz`` keys, shapes, dtypes and values, each frame's
  ``face.png``, the phases of ``timings.json``, the summary rows; a resumed
  run equal to an uninterrupted one; a checkpoint stream that survives a
  crash between its append and its count.

The two runs follow one trajectory only where neither sits on an |x| kink,
whose gradient JAX takes as 1 at 0 and PyTorch as 0 (ROADMAP Queue 3). So,
as in ``tests/test_torch_{step,dense_step}.py``, the targets carry an offset
(the black background is otherwise rendered exactly), the truth's colors
differ from the initial ones, the scales are anisotropic (an isotropic
splat's rotation gradient is rounding noise), and the dense soft-color L1,
whose anchor equals the colors at a frame's first step, is off. A tracked
frame's first step after the warm start still sits on the rigid loss's kink,
so tracked rotations are held only to the bound of two packages' Adam steps. The JAX
run uses the Pallas blend in interpret mode: its "tiled" renderer caps each
tile at a capacity the dense Gaussians overflow.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.pipeline.checkpoint import load_params as j_load_params
from topo4d_tpu.pipeline.data import SyntheticSequence as JSequence
from topo4d_tpu.pipeline.export import exported_vertices as j_exported_vertices
from topo4d_tpu.pipeline.export import write_texture as j_write_texture
from topo4d_tpu.pipeline.scene import build_scene as j_build_scene
from topo4d_tpu.pipeline.trainer import Trainer as JTrainer
from topo4d_tpu.testing import make_camera_ring as j_ring
from topo4d_tpu.testing import make_grid_mesh as j_grid
from topo4d_tpu.testing import make_synthetic_regions as j_regions
from topo4d_tpu.topology.obj_io import MeshObj as JMesh
from topo4d_tpu.topology.obj_io import write_obj_with_uv as j_write_obj

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.pipeline.checkpoint import load_params, load_resume, save_resume
from topo4d_tpu_torch.pipeline.data import SyntheticSequence
from topo4d_tpu_torch.pipeline.export import build_bake_binning, exported_vertices, write_texture
from topo4d_tpu_torch.pipeline.trainer import Trainer
from topo4d_tpu_torch.testing import make_camera_ring
from topo4d_tpu_torch.texture.bake_tiled import LAUNCHES, reset_launches
from topo4d_tpu_torch.topology.obj_io import write_obj_with_uv
from topo4d_tpu_torch.utils.png import encode_png, write_png

CPU = "cpu"


def _grid_scene(rows=10, density=2, num_views=4, jcfg=None):
    """The tests/test_pipeline.py grid head: (mesh, regions, params, JAX statics)."""
    verts, faces = j_grid(rows, rows, extent=0.5)
    uvs = np.stack(
        np.meshgrid(np.linspace(0.05, 0.95, rows), np.linspace(0.05, 0.95, rows), indexing="xy"), -1
    ).reshape(-1, 2).astype(np.float32)
    mesh = JMesh(vertices=verts, uvs=uvs, faces=faces, uv_faces=[list(f) for f in faces])
    regions = j_regions(verts.shape[0], faces)
    if jcfg is None:
        jcfg = JConfig()
        jcfg.texture.gen_tex = True
        jcfg.texture.density = density
    params, js = j_build_scene(mesh, regions, jcfg, num_views=num_views)
    return mesh, regions, params, js


@pytest.fixture(scope="module")
def scene():
    return _grid_scene()


def _random_rigid(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    g = np.eye(4, dtype=np.float32)
    g[:3, :3] = q * np.sign(np.linalg.det(q))
    g[:3, 3] = rng.normal(0, 0.1, 3)
    return g


@pytest.mark.parametrize("frame", [1, 2])
def test_exported_vertices_match_jax(scene, frame):
    _, _, params, js = scene
    n = params["means3D"].shape[0]
    rng = np.random.default_rng(frame)
    means = params["means3D"] + rng.normal(0, 0.002, (n, 3)).astype(np.float32)
    log_scales = np.log(rng.uniform(2e-4, 3e-3, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    inv_g = _random_rigid(frame)
    want = np.asarray(j_exported_vertices(means, log_scales, rots, js.tri_faces, inv_g, frame != 1))
    t = torch.as_tensor
    got = exported_vertices(t(means), t(log_scales), t(rots), t(js.tri_faces), t(inv_g), frame != 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if frame == 1:
        np.testing.assert_allclose(got, means @ inv_g[:3, :3].T + inv_g[:3, 3], rtol=1e-5, atol=1e-6)


def test_write_obj_with_uv_matches_jax_bytes(scene, tmp_path):
    _, _, params, js = scene
    verts = params["means3D"] * np.float32(1.37) + np.float32(1e-3)
    write_obj_with_uv(str(tmp_path / "port.obj"), verts, js.faces, js.uvs, js.uv_faces)
    j_write_obj(str(tmp_path / "jax.obj"), verts, js.faces, js.uvs, js.uv_faces)
    port = (tmp_path / "port.obj").read_bytes()
    assert port == (tmp_path / "jax.obj").read_bytes()
    assert port.count(b"\nf ") == len(js.faces)


@pytest.mark.parametrize("shape,kind", [((1, 1), "random"), ((37, 53), "random"), ((64, 64), "flat"), ((20, 300), "ramp")])
def test_png_round_trips_through_pil(tmp_path, shape, kind):
    h, w = shape
    rng = np.random.default_rng(h * w)
    img = {
        "random": lambda: rng.integers(0, 256, (h, w, 3)),
        "flat": lambda: np.full((h, w, 3), 200),
        "ramp": lambda: np.broadcast_to(np.arange(w)[None, :, None] % 256, (h, w, 3)),
    }[kind]().astype(np.uint8)
    path = str(tmp_path / "t.png")
    write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (w, h)
        np.testing.assert_array_equal(np.asarray(im), img)
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))


def _decoded(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


def _assert_texture_close(got, want):
    """Equal but for truncation flips (|d| = 1 on at most 0.1% of the
    bytes) and JAX's edge cracks (0 in JAX's, covered in the port's)."""
    crack = (np.abs(got - want) > 1).any(-1)
    assert np.all(want[crack] == 0) and np.all(got[crack].max(-1) > 0)
    assert crack.mean() < 0.01
    d = np.abs(got - want)[~crack]
    assert d.max() <= 1 and (d == 1).mean() <= 1e-3


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_write_texture_matches_jax(scene, tmp_path, backend):
    """The port's one bake against each of JAX's."""
    _, _, _, js = scene
    nd = js.dense.topo.dense_vertices.shape[0]
    dense = {"dense_rgb_colors": np.random.default_rng(6).uniform(-0.1, 1.1, (nd, 3)).astype(np.float32)}
    jpath, ppath = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    j_write_texture(jpath, dense, js, 64, 16, 2, backend, interpret=True)
    statics = convert.statics_from_numpy(js)
    reset_launches()
    write_texture(ppath, convert.params_from_numpy(dense, CPU), statics, 64)
    assert LAUNCHES == {"uv_bake": 0, "uv_bake_plain": 1}
    got, want = _decoded(ppath), _decoded(jpath)
    assert got.shape == (64, 64, 3) and got.max() > 0
    _assert_texture_close(got, want)
    # a per-sequence binning gives the same bytes as a fresh one
    cached = str(tmp_path / "cached.png")
    write_texture(cached, convert.params_from_numpy(dense, CPU), statics, 64, build_bake_binning(statics, 64, CPU))
    np.testing.assert_array_equal(_decoded(cached), got)


# ---------------------------------------------------------------------------
# Trainer.run
# ---------------------------------------------------------------------------


def _configure(c, out_dir, frames):
    """The tests/test_pipeline.py:30 schedule on either package's config."""
    c.data.output_dir = str(out_dir)
    c.data.use_mask = False
    c.schedule.frame_num = frames
    c.schedule.init_opt_num = 12
    c.schedule.opt_num = 8
    c.schedule.polish_iters = 2
    c.schedule.log_freq = 4
    c.schedule.ckp_freq = 1
    c.schedule.dense_opt_num = 4
    c.schedule.dense_log_freq = 2
    c.texture.gen_tex = True
    c.texture.density = 2
    c.texture.tex_res = 64
    c.dense_weights.soft_color = 0.0  # the anchor's L1 kink: see the module docstring
    return c


TARGET_OFFSET = np.float32(0.05)


class _Offset:
    """A sequence whose targets carry ``TARGET_OFFSET``: see the module
    docstring."""

    def __init__(self, source):
        self.source = source

    def __getattr__(self, name):
        return getattr(self.source, name)

    def frame(self, t, full_res=False):
        f = self.source.frame(t, full_res=full_res)
        return None if f is None else f._replace(images=f.images + TARGET_OFFSET)


def _run_inputs(scene):
    """(initial params, truth) of the runs: anisotropic scales, the truth's
    colors redrawn."""
    _, _, params, _ = scene
    n = params["means3D"].shape[0]
    rng = np.random.default_rng(11)
    params = dict(params, log_scales=(params["log_scales"] + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32))
    return params, dict(params, rgb_colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))


def _port_run(scene, out_dir, frames, resume=False, num_frames=3, async_export=True, bake_backend="auto"):
    params, truth = _run_inputs(scene)
    cfg = _configure(Config(), out_dir, frames)
    cfg.schedule.async_export = async_export
    cfg.texture.bake_backend = bake_backend
    cams = make_camera_ring(4, width=48, height=32, distance=2.0, device=CPU)
    source = _Offset(SyntheticSequence(params=truth, cameras=cams, num_frames=num_frames))
    trainer = Trainer(cfg, source, params, convert.statics_from_numpy(scene[3]), device=CPU)
    trainer.run(resume=resume)
    return trainer, os.path.join(cfg.data.output_dir, cfg.data.exp, cfg.data.seq)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The port's 3-frame run and the JAX package's on the same inputs."""
    port, port_out = _port_run(scene, tmp_path_factory.mktemp("port"), 3)
    params, truth = _run_inputs(scene)
    jcfg = _configure(JConfig(), tmp_path_factory.mktemp("jax"), 3)
    jcfg.raster.backend = "pallas"
    jcfg.raster.interpret = True
    jcfg.schedule.use_scan = False
    jcfg.data.log_views = []
    source = _Offset(JSequence(params=truth, cameras=j_ring(4, width=48, height=32, distance=2.0), num_frames=3))
    JTrainer(jcfg, source, params, scene[3]).run(resume=False)
    return port, port_out, os.path.join(jcfg.data.output_dir, jcfg.data.exp, jcfg.data.seq)


def test_run_writes_every_frame(runs):
    _, out, _ = runs
    for t in (1, 2, 3):
        d = os.path.join(out, "%06d" % t)
        assert os.path.getsize(os.path.join(d, "face.obj")) > 0
        with Image.open(os.path.join(d, "face.png")) as im:
            assert im.size == (64, 64) and np.asarray(im).max() > 0
    for f in ("resume.pkl", "snapshots.pkl", "params.npz", "metrics.jsonl", "timings.json", "loss.json"):
        assert os.path.exists(os.path.join(out, f)), f
    assert load_resume(out)["frame"] == 3


def test_run_topology_is_byte_identical_across_frames(runs):
    _, out, _ = runs

    def f_lines(t):
        with open(os.path.join(out, "%06d" % t, "face.obj")) as fh:
            return [line for line in fh if line.startswith("f ")]

    assert f_lines(1) and f_lines(1) == f_lines(2) == f_lines(3)


def test_run_params_npz_matches_jax_layout(runs):
    _, out, jout = runs
    got, want = load_params(os.path.join(out, "params.npz")), j_load_params(os.path.join(jout, "params.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["means3D"].ndim == 3 and got["cam_m"].ndim == 2  # frame-0-only keys unstacked


def test_run_params_npz_values_match_jax(runs):
    """Every key of every frame within 1e-6 of JAX's, but for the tracked
    frames' rotations (the rigid loss's kink: see the module docstring),
    which stay within the bound of two packages' Adam steps."""
    trainer, out, jout = runs
    got, want = load_params(os.path.join(out, "params.npz")), j_load_params(os.path.join(jout, "params.npz"))
    sched, lrs = trainer.cfg.schedule, trainer.cfg.lrs
    for k in want:
        if k == "unnorm_rotations":
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=0, atol=1e-6, err_msg=k)
            bound = 2 * sched.opt_num * max(lrs.track[k], lrs.polish[k])
            d = np.abs(got[k][1:] - want[k][1:])
            assert d.max() <= bound, (d.max(), bound)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_run_textures_match_jax(runs):
    """Each frame's decoded ``face.png`` against the JAX run's."""
    _, out, jout = runs
    for t in (1, 2, 3):
        got = _decoded(os.path.join(out, "%06d" % t, "face.png"))
        _assert_texture_close(got, _decoded(os.path.join(jout, "%06d" % t, "face.png")))


def test_run_with_the_xla_bake_matches_jax(runs, scene, tmp_path):
    """``texture.bake_backend: "xla"``: each frame's ``face.png`` from the
    banded bake, with no bake binning built, against the JAX run's (whose
    "auto" on the CPU is its "xla" bake) at ``test_run_textures_match_jax``'s
    tolerance, and equal byte for byte to the port's "auto" run's (K6's plain
    version)."""
    _, auto_out, jout = runs
    trainer, out = _port_run(scene, tmp_path, 3, bake_backend="xla")
    assert trainer._bake_binning is None
    for t in (1, 2, 3):
        png = os.path.join("%06d" % t, "face.png")
        with open(os.path.join(out, png), "rb") as a, open(os.path.join(auto_out, png), "rb") as b:
            assert a.read() == b.read(), t
        _assert_texture_close(_decoded(os.path.join(out, png)), _decoded(os.path.join(jout, png)))


def test_run_timings_and_summary_rows(runs):
    trainer, out, jout = runs
    with open(os.path.join(out, "timings.json")) as fh:
        timings = json.load(fh)
    for phase in ("geometry", "texture", "checkpoint", "export"):
        assert timings[phase]["count"] == 3 and timings[phase]["seconds"] > 0, phase
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert rows == trainer.metrics_log
    summaries = [r for r in rows if r.get("summary")]
    assert [r["frame"] for r in summaries] == [0, 1, 2]
    assert all(r["mpix_per_s"] > 0 and np.isfinite(r["frame_seconds"]) for r in summaries)
    assert summaries[0]["max_dmeans3d"] == 0.0 and summaries[1]["max_dmeans3d"] > 0  # frame 0 holds means3D
    with open(os.path.join(jout, "metrics.jsonl")) as fh:
        j_summary = [json.loads(line) for line in fh if json.loads(line).get("summary")]
    assert [sorted(r) for r in summaries] == [sorted(r) for r in j_summary]
    assert np.isfinite(rows[0]["loss_total"])


def test_resumed_run_equals_uninterrupted(scene, tmp_path):
    """One frame, then ``run(resume=True)`` to two, in a new trainer, against
    two frames in one run with the export inline (``async_export`` off;
    ``tests/test_pipeline.py:247``): the resumed trainer rebuilds its texture
    step for the restored state and keeps the first frame's metric rows."""
    whole, whole_out = _port_run(scene, tmp_path / "whole", 2, async_export=False)
    _port_run(scene, tmp_path / "split", 1)
    second, split_out = _port_run(scene, tmp_path / "split", 2, resume=True)
    assert os.path.exists(os.path.join(split_out, "000002", "face.png"))
    assert load_resume(split_out)["frame"] == 2
    a, b = load_params(os.path.join(whole_out, "params.npz")), load_params(os.path.join(split_out, "params.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in whole.texture_state.params.items():
        np.testing.assert_allclose(second.texture_state.params[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    with open(os.path.join(split_out, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    assert {r["frame"] for r in rows if r.get("summary")} == {0, 1}
    assert len(rows) == len(whole.metrics_log)
    for t in (1, 2):  # the same files from the export thread and inline
        for f in ("face.obj", "face.png"):
            with open(os.path.join(whole_out, "%06d" % t, f), "rb") as a_fh, open(
                os.path.join(split_out, "%06d" % t, f), "rb"
            ) as b_fh:
                assert a_fh.read() == b_fh.read(), (t, f)
    with open(os.path.join(split_out, "timings.json")) as fh:
        assert json.load(fh)["geometry"]["count"] == 2
    # a third run finds nothing left to do
    _port_run(scene, tmp_path / "split", 2, resume=True)
    assert load_resume(split_out)["frame"] == 2


def test_run_refuses_what_is_not_ported(scene, tmp_path):
    """Nothing of the dense loop's cadence is refused any more: a run with
    ``texture.rebin_freq`` 1 (a fresh binning in every dense render) equals
    the run at 0 (one frozen binning per frame and view), as the dense
    means3D do not move within a frame: metric rows at rtol 1e-4, the dense
    colors within 2 lr steps, 99.9% within 1e-6 (the tolerances of
    ``tests/test_torch_dense_step.py``), the geometry bit for bit."""
    params, truth = _run_inputs(scene)
    cams = make_camera_ring(4, width=48, height=32, distance=2.0, device=CPU)
    runs = []
    for rebin in (0, 1):
        cfg = _configure(Config(), tmp_path / f"rebin{rebin}", 1)
        cfg.texture.rebin_freq = rebin
        source = _Offset(SyntheticSequence(params=truth, cameras=cams, num_frames=1))
        trainer = Trainer(cfg, source, params, convert.statics_from_numpy(scene[3]), device=CPU)
        trainer.run(resume=False)
        runs.append(trainer)
    frozen, fresh = runs
    for k, v in frozen.state.params.items():
        assert torch.equal(fresh.state.params[k], v), k
    rows = [[r for r in t.metrics_log if "summary" not in r] for t in runs]
    assert len(rows[0]) == len(rows[1]) and any("tex_psnr_fixed" in r for r in rows[0])
    for a, b in zip(*rows):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6, err_msg=k)
    steps, lr = cfg.schedule.dense_opt_num, cfg.lrs.dense["dense_rgb_colors"]
    a = frozen.texture_state.params["dense_rgb_colors"].numpy()
    d = np.abs(fresh.texture_state.params["dense_rgb_colors"].numpy() - a)
    assert d.max() <= 2 * lr * steps + 1e-6 and np.mean(d <= 1e-6) >= 0.999, d.max()


def test_save_resume_cuts_an_orphan_record(tmp_path):
    """A save that crashed after its append and before its count leaves an
    orphan record; the next save cuts it off, so later records keep their
    places (JAX's stream keeps it: ROADMAP Queue 3)."""
    out = str(tmp_path)
    snaps = [{"means3D": np.full((2, 3), float(i), np.float32)} for i in range(3)]
    state = {"x": torch.ones(2)}
    save_resume(out, 1, state, {}, None, snaps[:1])
    with open(os.path.join(out, "snapshots.pkl"), "ab") as fh:
        pickle.dump({"means3D": np.full((2, 3), -1.0, np.float32)}, fh)
    assert [s["means3D"][0, 0] for s in load_resume(out)["output_params"]] == [0.0]
    save_resume(out, 2, state, {}, None, snaps[:2])
    save_resume(out, 3, state, {}, None, snaps)
    payload = load_resume(out)
    assert payload["frame"] == 3 and [s["means3D"][0, 0] for s in payload["output_params"]] == [0.0, 1.0, 2.0]
    np.testing.assert_array_equal(payload["state"]["x"], np.ones(2, np.float32))
