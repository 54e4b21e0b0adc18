"""The staged comparison of the tex8k protocol's dense phase: the PyTorch port
against the JAX package on the CPU, stage by stage, at the protocol's
configuration (``scripts/run_tex8k_r05.py``: the 92x90 head grid with its UV
seam, density 30 on the 18x18 seam patch, ``raster.max_span`` 2, the pallas
backend, 24 views at 375x512, dense views at ratio 8, 3000x4096).

Both dense phases start from one state: the known scene's colours stand in
for the fitted geometry's (with ``build_scene``'s writes), JAX's
``init_dense_params`` gives the dense set, and ``topo4d_tpu_torch/convert.py``
carries it into the port. JAX renders through its Pallas kernels in
interpret mode; the port through its plain versions.

    JAX_PLATFORMS=cpu python tests/tex8k_staged.py STAGE [--work DIR]

STAGE, in the order the protocol runs them:

- ``work``: the working views (375x512) of JAX's fabricator
  (``render_gaussians_tiled(max_span=4, capacity=512)``) against the
  port's (``validate/fabricate.py`` ``render_frame``), every view;
- ``targets``: JAX's dense targets of every view (~35 s a view), kept under
  the work directory for the later stages;
- ``a``: the dense targets of views 0 and 15 against the port's;
- ``b``: the dense set (``build_scene`` and ``init_dense_params`` of each
  package, the seam-aware topology): counts, means, colours, scales; keeps
  JAX's set (its float32 brute-force k-NN takes ~12 min);
- ``c``: view 0's first render and photometric loss from JAX's set, with
  the frozen binning, static rows and the trainer's auto compact capacity;
- ``steps SIDE N``: N dense steps of the protocol's view order from JAX's
  set (SIDE ``jax`` or ``port``; ``port-torch-abs`` runs the port with
  ``torch.abs``'s derivative 0 at a zero residual, as before ``l1_abs``), a JSON
  row per step (view 0's PSNR at steps 1, 5, 10, 20, 50), the colours
  after step 1 and step N kept; ``compare N`` holds the kept colours of
  the sides against JAX's;
- ``geo0``: one batched geometry step of each package's CLI on one JAX
  working tree (``--views_per_step 0``, the protocol's config): the first
  metrics row, the one JAX's TPU run logged as ``loss_im`` 0.07378 and
  PSNR 18.8695.

A ``jax`` steps run takes ~200 s a step here, the port's ~120 s.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import topo4d_tpu_torch  # noqa: E402,F401  (bound to this checkout before the JAX scripts move sys.path)

ROWS, COLS, VIEWS, WORK_W, WORK_H, RATIO, DENSITY, SPAN = 92, 90, 24, 375, 512, 8, 30, 2
DENSE_LR = {"dense_rgb_colors": 2.5e-3, "dense_unnorm_rotations": 1e-3,
            "dense_logit_opacities": 0.0, "dense_log_scales": 0.0}
WEIGHTS = {"im": 1.0, "soft_color": 0.02}
EVAL_AT = (1, 5, 10, 20, 50)


def known_scene():
    from topo4d_tpu.testing import make_grid_mesh

    from topo4d_tpu_torch.testing import grid_scene

    verts, _ = make_grid_mesh(ROWS, COLS, extent=0.5)
    return grid_scene(verts, ROWS, COLS)


def j_cams(ratio):
    from topo4d_tpu.core.camera import Camera
    from topo4d_tpu.testing import make_camera_ring

    c = make_camera_ring(VIEWS, width=WORK_W, height=WORK_H, distance=2.0)
    return Camera(w2c=c.w2c, fx=np.asarray(c.fx) * ratio, fy=np.asarray(c.fy) * ratio, cx=np.asarray(c.cx) * ratio,
                  cy=np.asarray(c.cy) * ratio, width=WORK_W * ratio, height=WORK_H * ratio)


def t_cams(ratio):
    from topo4d_tpu_torch.core.camera import make_camera
    from topo4d_tpu_torch.testing import make_camera_ring

    c = make_camera_ring(VIEWS, width=WORK_W, height=WORK_H, distance=2.0, device="cpu")
    k = np.zeros((VIEWS, 3, 3))
    k[:, 0, 0], k[:, 1, 1] = c.fx.numpy() * ratio, c.fy.numpy() * ratio
    k[:, 0, 2], k[:, 1, 2] = c.cx.numpy() * ratio, c.cy.numpy() * ratio
    k[:, 2, 2] = 1.0
    return make_camera(k, c.w2c.numpy(), WORK_W * ratio, WORK_H * ratio, device="cpu")


def j_fabricated(cams, views):
    """JAX's fabricator render (``fabricate_fast.py``) -> {view: (H, W, 3) uint8}."""
    import jax
    import jax.numpy as jnp
    from topo4d_tpu.core.gaussian import activate_params
    from topo4d_tpu.rasterizer.tiled import render_gaussians_tiled

    rv = activate_params({k: jnp.asarray(v) for k, v in known_scene().items()})
    dev = jax.tree_util.tree_map(jnp.asarray, cams)

    @jax.jit
    def render(i):
        return jnp.clip(render_gaussians_tiled(rv, dev[i], max_span=4, capacity=512).image.transpose(1, 2, 0) * 255.0,
                        0, 255).astype(jnp.uint8)

    return {v: np.asarray(render(jnp.asarray(v, jnp.int32))) for v in views}


def t_fabricated(cams, views):
    from topo4d_tpu_torch.validate.fabricate import render_frame

    scene = known_scene()
    return {v: render_frame(scene, scene["means3D"], cams[[v]])[0] for v in views}


def apart(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return {"apart": int((d > 0).sum()), "of": int(d.size), "share": float(np.mean(d > 0)), "max": int(d.max())}


def stage_work(work):
    j = j_fabricated(j_cams(1), range(VIEWS))
    t = t_fabricated(t_cams(1), range(VIEWS))
    for v in range(VIEWS):
        print(json.dumps({"view": v, **apart(j[v], t[v])}), flush=True)


def target_path(work, v):
    return os.path.join(work, "targets", f"view{v:02d}.npy")


def stage_targets(work):
    os.makedirs(os.path.join(work, "targets"), exist_ok=True)
    cams = j_cams(RATIO)
    for v in range(VIEWS):
        if not os.path.exists(target_path(work, v)):
            t0 = time.time()
            np.save(target_path(work, v), j_fabricated(cams, [v])[v])
            print(f"view {v}: {time.time() - t0:.1f} s", flush=True)


def target(work, v):
    return np.load(target_path(work, v)).astype(np.float32).transpose(2, 0, 1) / 255.0


def stage_a(work):
    cams = t_cams(RATIO)
    for v in (0, 15):
        print(json.dumps({"view": v, **apart(np.load(target_path(work, v)), t_fabricated(cams, [v])[v])}), flush=True)


def scenes(work):
    """Both packages' scene of JAX's fabricated mesh and regions."""
    from fabricate_dataset import fabricate
    from topo4d_tpu.config import Config as JConfig
    from topo4d_tpu.pipeline.scene import build_scene as j_build
    from topo4d_tpu.topology.obj_io import load_obj as j_load
    from topo4d_tpu.topology.regions import load_facial_regions as j_regions

    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.topology.obj_io import load_obj
    from topo4d_tpu_torch.topology.regions import load_facial_regions

    root = os.path.join(work, "mesh")
    if not os.path.exists(os.path.join(root, "assets", "facial_regions.pkl")):
        fabricate(root, 1, 1, ROWS, COLS, 16, 16, 1, 0.004, dense_tree=False, uv_seam=True)
    obj, pkl = os.path.join(root, "seq01", "face_v5.obj"), os.path.join(root, "assets", "facial_regions.pkl")
    out = []
    for cfg, build, load, regions in ((JConfig(), j_build, j_load, j_regions),
                                      (Config(), build_scene, load_obj, load_facial_regions)):
        cfg.texture.gen_tex, cfg.texture.density, cfg.texture.tex_res, cfg.raster.max_span = True, DENSITY, 8192, SPAN
        r = regions(pkl)
        p, s = build(load(obj), r, cfg, num_views=VIEWS)
        p["rgb_colors"] = known_scene()["rgb_colors"].copy()
        p["rgb_colors"][r.masks["dynamic_mouth_masks"]] = 0.0
        p["rgb_colors"][r.masks["dynamic_eye_masks"]] = 1.0
        out += [p, s]
    return out


def stage_b(work):
    import jax.numpy as jnp
    from topo4d_tpu.pipeline.scene import init_dense_params as j_init
    from topo4d_tpu.topology.interpolate import interpolate_dense_attribute as j_interp

    from topo4d_tpu_torch.pipeline.scene import init_dense_params

    jp, js, tp, ts = scenes(work)

    def diff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "iub":
            return {"equal": bool(np.array_equal(a, b))}
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        return {"max": float(d.max()), "max_rel": float((d / np.maximum(np.abs(a), 1e-30)).max())}

    jt, tt = js.dense.topo, ts.dense.topo
    print(json.dumps({"count": [int(jt.dense_vertices.shape[0]), int(tt.dense_vertices.shape[0])],
                      "seam_edge_instances": [int(jt.num_seam_edge_instances), int(tt.num_seam_edge_instances)]}))
    for f in ("dense_vertices", "quad_faces", "father_face", "weights"):
        print(json.dumps({"topology." + f: diff(getattr(jt, f), getattr(tt, f))}))
    t0 = time.time()
    jd = j_init(jp, js, VIEWS)
    print(f"JAX init_dense_params {time.time() - t0:.1f} s", flush=True)
    td = init_dense_params(tp, ts, VIEWS)
    for k in jd:
        print(json.dumps({k: diff(jd[k], td[k])}))
    ls = np.asarray(jd["dense_log_scales"], np.float64)[:, 0] - np.asarray(td["dense_log_scales"], np.float64)[:, 0]
    print(json.dumps({"log_scale_difference": {"mean": float(ls.mean()), "std": float(ls.std())}}))
    means = np.asarray(j_interp(jnp.asarray(jp["means3D"]), jnp.asarray(jt.quad_faces), jnp.asarray(jt.father_face),
                                jnp.asarray(jt.weights)))
    np.savez(os.path.join(work, "dense0.npz"), means=means, **{k: np.asarray(v) for k, v in jd.items()})
    with open(os.path.join(work, "regions.json"), "w") as fh:
        json.dump({k: np.asarray(js.regions.masks[k]).tolist() for k in
                   ("static_masks", "dynamic_masks", "mouth_inner_masks")}, fh)


def dense_state(work):
    z = np.load(os.path.join(work, "dense0.npz"))
    return {k: z[k] for k in z.files if k != "means"}, z["means"]


def pre_regions(work):
    """The regions the dense pre-step writes read, as both packages take them."""
    from topo4d_tpu_torch.topology.regions import FacialRegions

    with open(os.path.join(work, "regions.json")) as fh:
        masks = {k: np.asarray(v, np.int64) for k, v in json.load(fh).items()}
    return FacialRegions(region_masks={}, masks=masks, flat_faces={})


def sides(work, views):
    """{"jax": (render, step, eval, state, binnings, pre), "port": ...} for ``views``."""
    import jax
    import jax.numpy as jnp
    import torch
    from topo4d_tpu.opt.adam import adam_init as j_adam_init
    from topo4d_tpu.pipeline.scene import build_dense_pre_constraints as j_pre
    from topo4d_tpu.rasterizer.pallas import attach_compact as j_attach
    from topo4d_tpu.rasterizer.pallas import binning_for as j_binning_for
    from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas
    from topo4d_tpu.texture import dense as jd

    from topo4d_tpu_torch import convert
    from topo4d_tpu_torch.opt.adam import adam_init
    from topo4d_tpu_torch.pipeline.scene import build_dense_pre_constraints
    from topo4d_tpu_torch.rasterizer.render import attach_compact, binning_for, render_gaussians
    from topo4d_tpu_torch.texture import dense as td

    dense, means = dense_state(work)
    regions = pre_regions(work)

    def capacity(bs, count):
        occ = max(count(b) for b in bs.values())
        return -(-int(occ * 1.2) // 2048) * 2048  # the trainers' auto capacity above 8,192 tiles

    def make_jax():
        p = {k: jnp.asarray(v) for k, v in dense.items()}
        m = jnp.asarray(means)
        cams = jax.tree_util.tree_map(jnp.asarray, j_cams(RATIO))
        bs = {v: j_binning_for(jd.dense_rendervars(p, m), cams[v], max_span=SPAN, with_static=True) for v in views}
        cap = capacity(bs, lambda b: int(jnp.sum(b.tile_count > 0)))
        bs = {v: j_attach(b, cap) for v, b in bs.items()}

        def render(rv, cam, b):
            return render_gaussians_pallas(rv, cam, max_span=SPAN, interpret=True, binning=b)

        return {"render": render, "step": jd.make_texture_step(render), "eval": jd.make_texture_eval(render),
                "state": jd.TextureState(params=p, opt=j_adam_init(p)), "means": m, "cams": cams, "bs": bs,
                "pre": j_pre(p, regions), "cap": cap, "rv": lambda st: jd.dense_rendervars(st.params, m),
                "gt": lambda v: jnp.asarray(target(work, v)), "vid": lambda v: jnp.asarray(v, jnp.int32),
                "lr": {k: jnp.asarray(v, jnp.float32) for k, v in DENSE_LR.items()},
                "w": {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}}

    def make_port():
        p = convert.params_from_numpy(dense, "cpu")
        m = torch.as_tensor(means)
        cams = t_cams(RATIO)
        bs = {v: binning_for(td.dense_rendervars(p, m), cams[v], max_span=SPAN, with_static=True) for v in views}
        cap = capacity(bs, lambda b: int(torch.sum(b.tile_count > 0)))
        bs = {v: attach_compact(b, cap) for v, b in bs.items()}

        def render(rv, cam, b):
            return render_gaussians(rv, cam, max_span=SPAN, binning=b)

        return {"render": render, "step": td.make_texture_step(render), "eval": td.make_texture_eval(render),
                "state": td.TextureState(params=p, opt=adam_init(p)), "means": m, "cams": cams, "bs": bs,
                "pre": build_dense_pre_constraints(dense, regions, "cpu"), "cap": cap,
                "rv": lambda st: td.dense_rendervars(st.params, m),
                "gt": lambda v: torch.as_tensor(target(work, v)), "vid": lambda v: v, "lr": DENSE_LR, "w": WEIGHTS}

    return make_jax, make_port


def stage_c(work):
    import torch
    from topo4d_tpu.losses.image import photometric_loss as j_photo

    from topo4d_tpu_torch.losses.image import photometric_loss

    make_jax, make_port = sides(work, [0])
    out = {}
    for name, make, loss in (("jax", make_jax, lambda im, gt: float(j_photo(im, gt))),
                             ("port", make_port, lambda im, gt: float(photometric_loss(im, gt)))):
        s = make()
        t0 = time.time()
        with torch.no_grad():
            o = s["render"](s["rv"](s["state"]), s["cams"][0], s["bs"][0])
        img = np.asarray(o.image)
        b = s["bs"][0]
        out[name] = img
        print(json.dumps({"side": name, "loss": loss(o.image, s["gt"](0)), "num_cropped": int(o.num_cropped),
                          "capacity": s["cap"], "entries": int(np.asarray(b.tile_count).sum()),
                          "most_entries_of_a_tile": int(np.asarray(b.tile_count).max()),
                          "occupied_tiles": int(np.sum(np.asarray(b.tile_count) > 0)), "s": time.time() - t0}),
              flush=True)
        del s
    d = np.abs(out["jax"] - out["port"])
    print(json.dumps({"image_max_abs": float(d.max()), "values_beyond_1e-5": int(np.sum(d > 1e-5 + 1e-4 * np.abs(
        out["jax"]))), "of": int(d.size)}))


def stage_steps(work, side, n):
    from topo4d_tpu.pipeline.data import view_order

    order = [int(v) for v in view_order(VIEWS, 301, seed=10_000)[:n]]
    make_jax, make_port = sides(work, sorted(set(order) | {0}))
    if side == "port-torch-abs":
        import torch

        from topo4d_tpu_torch.texture import dense as td

        td.l1_loss_sum_last = lambda x, y: torch.mean(torch.sum(torch.abs(x - y), dim=-1))
    s = make_jax() if side == "jax" else make_port()
    state = s["state"]
    anchor = state.params["dense_rgb_colors"]
    for i, v in enumerate(order):
        t0 = time.time()
        state, m = s["step"](state, s["means"], s["gt"](v), s["cams"], s["vid"](v), anchor, s["pre"], s["lr"], s["w"],
                             s["bs"][v])
        row = {"step": i + 1, "view": v, **{k: float(x) for k, x in m.items()}}
        if i + 1 in EVAL_AT:
            row["psnr_fixed"] = float(s["eval"](state, s["means"], s["gt"](0), s["cams"], s["vid"](0), s["bs"][0]))
        row["s"] = time.time() - t0
        print(json.dumps(row), flush=True)
        if i + 1 in (1, n):
            np.save(os.path.join(work, f"colors_{side}_{i + 1}.npy"), np.asarray(state.params["dense_rgb_colors"]))


def stage_compare(work, n):
    want = np.load(os.path.join(work, f"colors_jax_{n}.npy"))
    for side in ("port", "port-torch-abs"):
        path = os.path.join(work, f"colors_{side}_{n}.npy")
        if os.path.exists(path):
            d = np.abs(np.load(path) - want)
            print(json.dumps({"side": side, "steps": n, "max": float(d.max()), "within_1e-6": float(np.mean(d <= 1e-6)),
                              "beyond_1e-6": int(np.sum(d > 1e-6)), "of": int(d.size)}))


def stage_geo0(work):
    """One batched geometry step of each CLI on a JAX working tree."""
    from fabricate_dataset import fabricate

    root = os.path.join(work, "geo0", "fab")
    if not os.path.exists(os.path.join(root, "seq01", "cameras.xml")):
        fabricate(root, VIEWS, 1, ROWS, COLS, WORK_W, WORK_H, RATIO, 0.004, dense_tree=False, uv_seam=True)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    flags = ["-id", root, "-s", "seq01", "-e", "x", "-fn", "1", "-ion", "1", "-on", "1", "-dr", str(RATIO), "-lf",
             "500", "-cf", "1", "--backend", "pallas", "--no_mask", "--views_per_step", "0"]
    for name, cfg_mod, cmd in (
        ("jax", "topo4d_tpu.config", [sys.executable, "-m", "topo4d_tpu.cli", "--interpret", "--no_resume"]),
        ("port", "topo4d_tpu_torch.config", [sys.executable, "-m", "topo4d_tpu_torch", "--device", "cpu"]),
    ):
        cfg_path, out = os.path.join(work, "geo0", f"{name}.json"), os.path.join(work, "geo0", name)
        subprocess.run([sys.executable, "-c", f"from {cfg_mod} import Config; c = Config(); c.raster.max_span = "
                        f"{SPAN}; c.texture.allview_eval = True; open({cfg_path!r}, 'w').write(c.to_json())"],
                       env=env, check=True)
        subprocess.run(cmd + ["--config", cfg_path, "-od", out] + flags, env=env, check=True, capture_output=True)
        with open(os.path.join(out, "x", "seq01", "metrics.jsonl")) as fh:
            row = json.loads(fh.readline())
        print(json.dumps({"side": name, "loss_im": row["loss_im"], "psnr": row["psnr"]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", choices=["work", "targets", "a", "b", "c", "steps", "compare", "geo0"])
    ap.add_argument("args", nargs="*")
    ap.add_argument("--work", default=os.path.join(REPO, "build", "tex8k_staged"))
    a = ap.parse_args()
    os.makedirs(a.work, exist_ok=True)
    if a.stage == "steps":
        stage_steps(a.work, a.args[0], int(a.args[1]))
    elif a.stage == "compare":
        stage_compare(a.work, int(a.args[0]))
    else:
        {"work": stage_work, "targets": stage_targets, "a": stage_a, "b": stage_b, "c": stage_c,
         "geo0": stage_geo0}[a.stage](a.work)


if __name__ == "__main__":
    main()
