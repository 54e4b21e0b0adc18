"""The validation protocols of the PyTorch port (``topo4d_tpu_torch/validate``)
against the JAX scripts they replace (``scripts/``) and the JAX package, on
the CPU:

(a) the fabricator against ``fabricate_dataset.py`` ``fabricate`` (4 views,
    48x32, 3 frames, a 10x10 grid, ratio 4, motion 0.004, with and without
    ``uv_seam``): the OBJ's records and ``facial_regions.pkl`` equal, the
    cameras as the port's loader reads them within rtol 1e-6, every image
    and parsing image within one uint8 level (the two renderers' floats
    straddle an integer on at most 0.1% of the values); and the seam
    layout of the 92x90 head grid (its 18x18 seam-centred dense patch);
(b) ``score.py`` against JAX's scorer rebuilt from ``activate_params``,
    ``render_gaussians_tiled(max_span=4, capacity=512)``,
    ``photometric_loss`` and ``psnr``, rtol 1e-5 as
    ``test_torch_losses.py`` holds ``photometric_loss``;
(c) the headline report (per-frame finals, the 1.2x criterion, the
    frozen-binning drift) against ``validate_headline.py``'s, exactly;
(d) ``verify_run`` against ``run_long_r04.py``'s on a port-made run and on
    a copy with one frame's topology changed, equal reports;
(e) ``sample_line`` and ``seam_check`` against ``run_tex8k_r05.py``'s on a
    seeded 256x256 texture, bit for bit;
(f) a tiny ``python -m topo4d_tpu_torch.validate headline --device cpu``
    (4 views, 2 frames, 12 init and 120 track steps) that writes every key
    of JAX's report and imports neither JAX nor the JAX package.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import run_long_r04 as j_long  # noqa: E402
import run_tex8k_r05 as j_tex8k  # noqa: E402
import validate_headline as j_headline  # noqa: E402
from fabricate_dataset import fabricate as j_fabricate  # noqa: E402
from topo4d_tpu.config import Config as JConfig  # noqa: E402
from topo4d_tpu.core.gaussian import activate_params as j_activate  # noqa: E402
from topo4d_tpu.losses.image import photometric_loss as j_photometric  # noqa: E402
from topo4d_tpu.losses.image import psnr as j_psnr  # noqa: E402
from topo4d_tpu.pipeline.data import DiskSequence as JDiskSequence  # noqa: E402
from topo4d_tpu.rasterizer.tiled import render_gaussians_tiled  # noqa: E402

from topo4d_tpu_torch.config import Config  # noqa: E402
from topo4d_tpu_torch.pipeline.data import DiskSequence  # noqa: E402
from topo4d_tpu_torch.validate import headline, long_run, score, tex8k  # noqa: E402
from topo4d_tpu_torch.validate.fabricate import fabricate  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = "-ion 12 -on 120 -lf 20 -cf 1"  # tracked frames run 20 steps before the 100 polish steps
HEADLINE_FRAMES = 2
FOREIGN = ("jax", "topo4d_tpu")


@pytest.fixture(scope="module", params=[False, True], ids=["grid_uvs", "uv_seam"])
def trees(request, tmp_path_factory):
    base = tmp_path_factory.mktemp("fab_seam" if request.param else "fab_grid")
    jroot, proot = str(base / "jax"), str(base / "port")
    kw = dict(num_views=4, num_frames=3, rows=10, cols=10, work_w=48, work_h=32, ratio=4, motion_scale=0.004,
              dense_tree=True, uv_seam=request.param)
    j_fabricate(jroot, **kw)
    fabricate(proot, device=CPU, **kw)
    return jroot, proot


@pytest.fixture(scope="module")
def headline_run(tmp_path_factory):
    """A port-made dataset (ratio 2, as the protocol's ``-dr 2`` reads it)
    and the headline protocol run on it by ``python -m
    topo4d_tpu_torch.validate`` in a child process, which reports the
    modules it imported."""
    base = tmp_path_factory.mktemp("headline")
    root, out = str(base / "fab"), str(base / "out")
    fabricate(root, num_views=4, num_frames=HEADLINE_FRAMES, ratio=2, motion_scale=0.004, dense_tree=False,
              device=CPU)
    argv = ["topo4d_tpu_torch.validate", "headline", root, out, str(HEADLINE_FRAMES), "--device", CPU,
            "--schedule", SCHEDULE]
    # one thread: the run is small, and the suite's workers share the cores
    code = (
        "import json, runpy, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('topo4d_tpu_torch.validate', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        f"print('IMPORTED', json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r})))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    imported = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("IMPORTED "))[len("IMPORTED "):])
    return root, out, imported


def _obj_records(path):
    with open(path) as fh:
        return [line for line in fh if line.split(" ", 1)[0] in ("v", "vt", "f")]


def _loader(root, ratio):
    cfg = Config()
    cfg.data.input_dir, cfg.data.seq = root, "seq01"
    cfg.data.dense_input_dir = root + "_dense"
    cfg.data.down_ratio, cfg.data.dense_down_ratio = ratio, 1
    return DiskSequence(cfg, device=CPU)


def test_fabricator_matches_jax(trees):
    jroot, proot = trees
    seq = ("seq01", "face_v5.obj")
    assert _obj_records(os.path.join(jroot, *seq)) == _obj_records(os.path.join(proot, *seq))

    def regions(root):
        with open(os.path.join(root, "assets", "facial_regions.pkl"), "rb") as fh:
            return pickle.load(fh)

    rj, rp = regions(jroot), regions(proot)
    assert sorted(rj) == sorted(rp)
    for k, v in rj.items():
        if isinstance(v, dict):
            assert sorted(v) == sorted(rp[k])
            for name in v:
                np.testing.assert_array_equal(np.asarray(v[name]), np.asarray(rp[k][name]), err_msg=f"{k}.{name}")
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(rp[k]), err_msg=k)

    sj, sp = _loader(jroot, 4), _loader(proot, 4)
    assert sj.view_names == sp.view_names
    for a, b in ((sj.cameras, sp.cameras), (sj.cameras_full, sp.cameras_full)):
        assert (a.width, a.height) == (b.width, b.height)
        for k in ("w2c", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(a, k).numpy(), getattr(b, k).numpy(), rtol=1e-6, atol=1e-7, err_msg=k)

    differ = total = files = 0
    for base in ("", "_dense"):
        for dirpath, _, names in os.walk(jroot + base):
            for name in names:
                if not name.endswith(".png"):
                    continue
                pj = os.path.join(dirpath, name)
                a = np.asarray(Image.open(pj)).astype(np.int16)
                b = np.asarray(Image.open(proot + base + pj[len(jroot + base):])).astype(np.int16)
                assert a.shape == b.shape, pj
                d = np.abs(a - b)
                assert d.max() <= 1, (pj, int(d.max()))
                differ += int((d > 0).sum())
                total += d.size
                files += 1
    # 3 frames x 4 views x (image + parsing image) x (working + dense), the template texture
    assert files == 49
    share = differ / total
    print(f"uint8 values one level apart: {differ} of {total} ({share:.2e})")
    assert share <= 1e-3


def test_score_matches_jax_scorer(headline_run):
    root, out, _ = headline_run
    npz = score.run_params(out, "parity")
    got = score.score_params(score.open_source(root, 2, CPU), npz, HEADLINE_FRAMES)

    cfg = JConfig()
    cfg.data.input_dir, cfg.data.seq, cfg.data.down_ratio, cfg.data.use_mask = root, "seq01", 2, False
    src = JDiskSequence(cfg)
    cams = src.cameras

    @jax.jit
    def view_scores(params, gt, vid):
        rv = j_activate(params)
        cam = jax.tree_util.tree_map(lambda x: x[vid], cams)
        im = render_gaussians_tiled(rv, cam, max_span=4, capacity=512).image
        im = jnp.exp(params["cam_m"][vid])[:, None, None] * im + params["cam_c"][vid][:, None, None]
        return j_photometric(im, gt), jnp.mean(j_psnr(im, gt))

    for t in range(HEADLINE_FRAMES):
        params = {k: jnp.asarray(npz[k][t]) for k in ("means3D", "rgb_colors", "unnorm_rotations")}
        params.update({k: jnp.asarray(npz[k]) for k in ("log_scales", "logit_opacities", "cam_m", "cam_c")})
        fd = src.frame(t + 1)
        pls, pss = zip(*[
            [float(x) for x in view_scores(params, jnp.asarray(fd.images[i]), jnp.asarray(i, jnp.int32))]
            for i in range(src.num_views)
        ])
        np.testing.assert_allclose(got[t]["photometric_mean"], np.mean(pls), rtol=1e-5)
        np.testing.assert_allclose(got[t]["psnr_mean"], np.mean(pss), rtol=1e-5)


def _run_outputs(out, name):
    seq = os.path.join(out, name, "val", "seq01")
    with open(os.path.join(seq, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    return rows, np.load(os.path.join(seq, "params.npz"))


def test_headline_report_matches_jax(headline_run, tmp_path, monkeypatch):
    _, out, _ = headline_run
    # batched0 and parity swapped, so that the drift between "headline" and
    # "batched0" is not zero; both sides read the same mapping
    source = {"headline": "headline", "batched0": "parity", "parity": "batched0"}
    runs = {name: _run_outputs(out, source[name]) for name in headline.MODES}
    monkeypatch.setattr(j_headline, "run_mode", lambda name, spec, root, out_root, frames: runs[name])
    monkeypatch.setattr(sys, "argv", ["validate_headline.py", "unused", str(tmp_path), str(HEADLINE_FRAMES)])
    j_headline.main()
    with open(tmp_path / "headline_validation.json") as fh:
        want = json.load(fh)

    results = {name: headline.mode_results(*runs[name]) for name in headline.MODES}
    got = json.loads(json.dumps(headline.headline_report(results, HEADLINE_FRAMES), default=float))
    assert got == want
    assert any(v > 0 for v in want["frozen_binning_means_drift"].values())
    assert headline.frame_finals(runs["parity"][0]) == j_headline.frame_finals(runs["parity"][0])


def test_verify_run_matches_jax(headline_run, tmp_path):
    _, out, _ = headline_run
    seq = os.path.join(out, "headline", "val", "seq01")
    changed = str(tmp_path / "seq01")
    shutil.copytree(seq, changed)
    obj = os.path.join(changed, "%06d" % HEADLINE_FRAMES, "face.obj")
    with open(obj) as fh:
        lines = fh.readlines()
    i = next(k for k, line in enumerate(lines) if line.startswith("f "))
    lines[i], lines[i + 1] = lines[i + 1], lines[i]
    with open(obj, "w") as fh:
        fh.writelines(lines)
    for path, stable in ((seq, True), (changed, False)):
        want = j_long.verify_run("headline", path, HEADLINE_FRAMES, 0.004)
        got = long_run.verify_run("headline", path, HEADLINE_FRAMES, 0.004)
        assert got == want
        assert got["topology_byte_stable"] is stable
        assert long_run.obj_vertices(path, 1).tolist() == j_long.obj_vertices(path, 1).tolist()


def test_seam_sampling_matches_jax():
    rng = np.random.default_rng(7)
    tex = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    tex[:, 100:120] = 0  # background across the control line: unlit pairs
    tex[200:, :] = 0
    for u in (0.1, 0.25, 0.46, 0.54, 0.9):
        a, b = tex8k.sample_line(tex, u), j_tex8k.sample_line(tex, u)
        assert a.dtype == b.dtype and np.array_equal(a, b), u
    for inset in (1.0, 3.0):
        assert tex8k.seam_check(tex, inset) == j_tex8k.seam_check(tex, inset)


def test_headline_cli_writes_jax_report_without_jax(headline_run):
    _, out, imported = headline_run
    assert imported == []
    with open(os.path.join(out, "headline_validation.json")) as fh:
        report = json.load(fh)
    for key in ("frames", "modes", "headline_within_1p2x_parity", "frozen_binning_means_drift"):
        assert key in report
    for name in headline.MODES:
        assert set(report["modes"][name]) == {"final_loss_per_frame", "final_psnr_per_frame", "max_dmeans3d_per_frame"}
        assert sorted(report["modes"][name]["final_loss_per_frame"]) == [str(t) for t in range(HEADLINE_FRAMES)]
        assert sorted(report["common_metric"][name]) == [str(t) for t in range(HEADLINE_FRAMES)]
        assert np.isfinite(report["common_metric"][name]["0"]["photometric_mean"])
    assert report["frames"] == HEADLINE_FRAMES


def test_seam_layout_matches_jax_at_head_scale(tmp_path):
    """The 92x90 head grid's UV islands and seam-centred dense patch (18x18
    vertices, which a 10x10 grid cannot show) against JAX's."""
    kw = dict(num_views=1, num_frames=1, rows=92, cols=90, work_w=16, work_h=16, ratio=1, dense_tree=False,
              uv_seam=True)
    j_fabricate(str(tmp_path / "jax"), **kw)
    fabricate(str(tmp_path / "port"), device=CPU, **kw)
    seq = ("seq01", "face_v5.obj")
    assert _obj_records(str(tmp_path / "jax" / os.path.join(*seq))) == _obj_records(
        str(tmp_path / "port" / os.path.join(*seq)))
    with open(tmp_path / "jax" / "assets" / "facial_regions.pkl", "rb") as fh:
        want = pickle.load(fh)["face_masks"]
    with open(tmp_path / "port" / "assets" / "facial_regions.pkl", "rb") as fh:
        got = pickle.load(fh)["face_masks"]
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.size == 18 * 18
