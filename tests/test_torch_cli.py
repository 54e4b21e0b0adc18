"""The port's command line (``topo4d_tpu_torch/cli.py``, ``python -m
topo4d_tpu_torch``) against the JAX package's (``topo4d_tpu/cli.py``).

- the flags: every flag of the JAX parser with its defaults, plus
  ``--device``; mirrors of ``tests/test_pipeline.py``'s
  ``test_cli_config_wiring`` and
  ``test_config_file_not_clobbered_by_default_flags``;
- ``Config.from_json`` on the ``config.json`` the JAX CLI writes for the
  same arguments, equal to the port's own; keys the port has no field for
  raise unless they hold JAX's default; ``--interpret`` and a missing card
  raise;
- a tiny drive, both ``--backend tiled``: a 2-view tree of the 6x6 head grid
  written by ``write_disk_sequence`` (two rotated views, a component
  transform, parsing masks, a 0.05 background), 2 frames, ``-t`` with
  ``data.use_mask_dense``, through ``cli.main`` of each package. As in
  ``tests/test_torch_export.py``, the runs start at anisotropic scales
  (both packages' ``build_scene`` wrapped alike: an isotropic splat's
  rotation gradient is rounding noise) with the soft-color anchor off, and
  the background keeps the targets off the |x| kink. Held there: params
  within 1e-6 but the tracked frames' rotations (within two packages' Adam
  steps), the OBJs (topology byte for byte, vertices rtol 1e-5 / atol
  1e-6), the metric rows (rtol 1e-5 / atol 1e-6), each ``face.png`` (as
  there) and the progress renders and their PSNR against JAX's
  ``report_progress`` (bytes within 1, as ``(x * 255)`` truncates);
- resume as a no-op, ``--no_resume``'s exit, and ``import
  topo4d_tpu_torch.cli`` in a process where ``jax`` cannot be imported.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import topo4d_tpu.pipeline.scene as j_scene
from topo4d_tpu.cli import build_argparser as j_build_argparser
from topo4d_tpu.cli import config_from_args as j_config_from_args
from topo4d_tpu.cli import main as j_main
from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.pipeline.checkpoint import load_params as j_load_params
from topo4d_tpu.pipeline.progress import report_progress as j_report_progress
from topo4d_tpu.rasterizer.tiled import render_gaussians_tiled as j_tiled
from topo4d_tpu.testing import make_camera_ring as j_ring

import topo4d_tpu_torch.pipeline.scene as p_scene
from topo4d_tpu_torch.cli import build_argparser, config_from_args, main
from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.pipeline.checkpoint import load_params, load_resume
from topo4d_tpu_torch.pipeline.progress import report_progress
from topo4d_tpu_torch.rasterizer import blend
from topo4d_tpu_torch.rasterizer.tiled import render_gaussians_tiled
from topo4d_tpu_torch.testing import make_camera_ring, write_disk_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPONENT = np.array([[0.0, -1.0, 0.0, 0.1], [1.0, 0.0, 0.0, 0.2], [0.0, 0.0, 1.0, 0.3], [0.0, 0.0, 0.0, 1.0]])


def _flags(parser):
    return {(tuple(sorted(a.option_strings)), a.dest, a.default, tuple(a.choices or ())) for a in parser._actions}


def test_every_jax_flag_plus_device():
    port, jax_ = _flags(build_argparser()), _flags(j_build_argparser())
    assert jax_ <= port
    assert {f[1] for f in port - jax_} == {"device"}
    device = build_argparser()._option_string_actions["--device"]
    assert device.default == "cuda" and tuple(device.choices) == ("cuda", "cpu")
    help_text = subprocess.run([sys.executable, "-m", "topo4d_tpu_torch", "--help"], cwd=REPO, capture_output=True,
                               text=True, check=True).stdout
    for opts, *_ in port:
        for o in opts:
            assert o in help_text, o


def test_cli_config_wiring():
    args = build_argparser().parse_args(
        ["-e", "expX", "-s", "seqY", "-fn", "10", "--gen_tex", "-tr", "512", "--backend", "tiled",
         "--views_per_step", "0"]
    )
    cfg = config_from_args(args)
    assert cfg.data.exp == "expX" and cfg.data.seq == "seqY"
    assert cfg.schedule.frame_num == 10
    assert cfg.texture.gen_tex and cfg.texture.tex_res == 512
    assert cfg.raster.backend == "tiled"
    assert cfg.schedule.views_per_step == 0
    cfg2 = Config.from_json(cfg.to_json())
    assert cfg2 == cfg
    assert cfg2.texture.tex_res == 512 and cfg2.weights.rigid == cfg.weights.rigid


def test_config_file_not_clobbered_by_default_flags(tmp_path):
    cfg = Config()
    cfg.schedule.frame_num = 123
    cfg.texture.gen_tex = True
    cfg.texture.tex_res = 256
    cfg.raster.backend = "tiled"
    cfg.data.use_mask_dense = True
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    out = config_from_args(build_argparser().parse_args(["--config", str(path), "-s", "seqZ"]))
    assert out.data.seq == "seqZ"
    assert out.schedule.frame_num == 123
    assert out.texture.gen_tex and out.texture.tex_res == 256
    assert out.raster.backend == "tiled" and out.data.use_mask_dense
    out2 = config_from_args(build_argparser().parse_args(["--config", str(path), "-fn", "7", "--no_mask"]))
    assert out2.schedule.frame_num == 7
    assert out2.data.use_mask is False and out2.data.use_mask_dense is False


ARGV = [
    ["-e", "expX", "-s", "seqY", "-fn", "10", "--gen_tex", "-tr", "512", "--backend", "tiled", "--views_per_step", "0"],
    ["-id", "/data", "-did", "/dense", "-dr", "4", "-ddr", "2", "-lv", "a", "b", "--no_mask", "--track_rebin_freq",
     "5", "-ion", "3", "-on", "2", "-don", "1", "-lf", "1", "-dlf", "1", "-cf", "2", "-dn", "3"],
    [],
]


@pytest.mark.parametrize("argv", ARGV)
def test_config_json_written_by_the_jax_cli_loads(argv, tmp_path):
    jcfg = j_config_from_args(j_build_argparser().parse_args(argv))
    jcfg.texture.dense_opt_num_tracked = 150
    jcfg.data.blacklist = ["K99216893"]
    cfg = Config.from_json(jcfg.to_json())
    mine = config_from_args(build_argparser().parse_args(argv))
    mine.texture.dense_opt_num_tracked = 150
    mine.data.blacklist = ["K99216893"]
    assert cfg == mine
    # and the JAX package reads the port's back
    assert JConfig.from_json(cfg.to_json()) == jcfg


def test_config_keys_the_port_lacks():
    raw = json.loads(JConfig().to_json())
    for path, value, err in [
        (("raster", "interpret"), True, ValueError),
        (("texture", "bake_backend"), "banded", ValueError),
        (("neighbor_weight_k",), 1000.0, ValueError),
        (("schedule", "no_such_key"), 1, ValueError),
    ]:
        bad = json.loads(json.dumps(raw))
        node = bad
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
        with pytest.raises(err, match=path[-1]):
            Config.from_json(json.dumps(bad))
    assert Config.from_json(json.dumps(raw)) == Config()
    # the bake keys load at every value JAX names, and round-trip with JAX's
    # config: "pallas" and "auto" bake through K6, "xla" through the banded
    # bake (an unknown backend raises above; JAX bakes it as "xla")
    for backend, window, bands in (("pallas", 16, 8), ("xla", 24, 5), ("auto", 9, 3)):
        jcfg = JConfig()
        jcfg.texture.bake_backend, jcfg.texture.bake_window, jcfg.texture.bake_bands = backend, window, bands
        cfg = Config.from_json(jcfg.to_json())
        assert (cfg.texture.bake_backend, cfg.texture.bake_window, cfg.texture.bake_bands) == (backend, window, bands)
        assert JConfig.from_json(cfg.to_json()) == jcfg
    # the multi-rank keys load at any value: tile sharding and the orbax
    # resume backend are ported; so are every dense binning cadence, the
    # photometric remat and the camera cap of a scene built without a view
    # count
    for path, value in ((("texture", "tile_shard"), True), (("data", "checkpoint_backend"), "orbax"),
                        (("data", "max_cams"), 12),
                        (("texture", "rebin_freq"), 1), (("texture", "rebin_freq"), -3),
                        (("texture", "remat_photometric"), True)):
        good = json.loads(json.dumps(raw))
        good[path[0]][path[1]] = value
        assert getattr(getattr(Config.from_json(json.dumps(good)), path[0]), path[1]) == value
    # the Pallas blend's entry window changes no result: any value loads
    raw["raster"]["chunk"] = 64
    assert Config.from_json(json.dumps(raw)) == Config()


def test_interpret_and_a_missing_card_raise(tmp_path):
    with pytest.raises(ValueError, match="--device cpu"):
        config_from_args(build_argparser().parse_args(["--interpret"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-id", str(tmp_path), "-od", str(tmp_path / "out")])


def test_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['topo4d_tpu'] = None\n"
        "import topo4d_tpu_torch.cli, topo4d_tpu_torch.__main__, topo4d_tpu_torch.pipeline.trainer\n"
        "import topo4d_tpu_torch.pipeline.data, topo4d_tpu_torch.rasterizer.tiled, topo4d_tpu_torch.rasterizer.reference\n"
        "import topo4d_tpu_torch.pipeline.progress, topo4d_tpu_torch.core.agisoft, topo4d_tpu_torch.testing\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'topo4d_tpu.')) and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# the tiny drive
# ---------------------------------------------------------------------------

VIEWS = ["K98707288", "K98707293"]  # rotated +1 and -1


def _anisotropic(build):
    def wrapped(*args, **kwargs):
        params, statics = build(*args, **kwargs)
        n = params["log_scales"].shape[0]
        jitter = np.random.default_rng(11).uniform(-0.3, 0.3, (n, 3))
        params["log_scales"] = (params["log_scales"] + jitter).astype(np.float32)
        return params, statics

    return wrapped


def _argv(tree, out, config):
    return [
        "-id", tree.input_dir, "-did", tree.dense_input_dir, "-s", tree.seq, "-od", str(out), "-e", "drive",
        "-fn", "2", "-ion", "12", "-on", "8", "-lf", "4", "-cf", "1", "-t", "-tr", "64", "-dn", "2", "-don", "4",
        "-dlf", "2", "-dr", "2", "-ddr", "1", "--backend", "tiled", "--config", config, "-lv", VIEWS[1], "nope",
    ]


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    tree = write_disk_sequence(
        str(base / "tree"), num_views=2, num_frames=2, rows=6, cols=6, width=32, height=48, ratio=2,
        view_names=VIEWS, component=COMPONENT, bg=(0.05, 0.05, 0.05), device="cpu",
    )
    config = str(base / "config.json")
    with open(config, "w") as fh:
        json.dump({"data": {"use_mask_dense": True}, "dense_weights": {"soft_color": 0.0}}, fh)
    mp = pytest.MonkeyPatch()
    mp.setattr(p_scene, "build_scene", _anisotropic(p_scene.build_scene))
    mp.setattr(j_scene, "build_scene", _anisotropic(j_scene.build_scene))
    try:
        blend.reset_launches()
        trainer = main(_argv(tree, base / "port", config) + ["--device", "cpu"])
        launches = dict(blend.LAUNCHES)
        j_main(_argv(tree, base / "jax", config))
    finally:
        mp.undo()
    out = os.path.join(base / "port", "drive", tree.seq)
    return tree, trainer, launches, out, os.path.join(base / "jax", "drive", tree.seq), _argv(tree, base / "port", config)


def test_drive_runs_masks_and_the_tiled_backend(drive):
    _, trainer, launches, out, _ = drive[:5]
    assert trainer.cfg.raster.backend == "tiled" and trainer._texture_masked is True
    assert launches["tile_blend_plain"] == 0  # no render went through the pallas path
    assert load_resume(out)["frame"] == 2
    with open(os.path.join(out, "config.json")) as fh:
        assert Config.from_json(fh.read()) == trainer.cfg


def test_drive_params_match_jax(drive):
    _, trainer, _, out, jout = drive[:5]
    got, want = load_params(os.path.join(out, "params.npz")), j_load_params(os.path.join(jout, "params.npz"))
    assert sorted(got) == sorted(want)
    sched, lrs = trainer.cfg.schedule, trainer.cfg.lrs
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k == "unnorm_rotations":
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=0, atol=1e-6, err_msg=k)
            bound = 2 * sched.opt_num * max(lrs.track[k], lrs.polish[k])
            assert np.abs(got[k][1:] - want[k][1:]).max() <= bound
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def _obj(path):
    with open(path) as fh:
        lines = fh.readlines()
    verts = np.array([[float(x) for x in line.split()[1:]] for line in lines if line.startswith("v ")])
    return verts, [line for line in lines if line.startswith("f ")]


def _decoded(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


def test_drive_outputs_match_jax(drive):
    _, _, _, out, jout = drive[:5]
    faces = None
    for t in (1, 2):
        v, f = _obj(os.path.join(out, "%06d" % t, "face.obj"))
        jv, jf = _obj(os.path.join(jout, "%06d" % t, "face.obj"))
        assert f == jf and (faces is None or f == faces)
        faces = f
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-6)
        got, want = _decoded(os.path.join(out, "%06d" % t, "face.png")), _decoded(os.path.join(jout, "%06d" % t, "face.png"))
        crack = (np.abs(got - want) > 1).any(-1)  # JAX's CPU bake leaves exact shared edges uncovered
        assert np.all(want[crack] == 0) and crack.mean() < 0.01
        d = np.abs(got - want)[~crack]
        assert d.max() <= 1 and (d == 1).mean() <= 1e-3
        vis = sorted(f for f in os.listdir(os.path.join(out, "%06d" % t)) if f.startswith("vis"))
        assert vis == sorted(f for f in os.listdir(os.path.join(jout, "%06d" % t)) if f.startswith("vis"))
        logged = (0, 4, 8, 11) if t == 1 else (0, 4, 7)  # every 4th step and the last; "nope" is no view
        assert vis == sorted(f"vis{VIEWS[1]}_{i}.png" for i in logged)
        for name in vis:
            a, b = _decoded(os.path.join(out, "%06d" % t, name)), _decoded(os.path.join(jout, "%06d" % t, name))
            assert a.shape == (48, 32, 3) and np.abs(a - b).max() <= 1


def test_drive_metric_rows_match_jax(drive):
    _, _, _, out, jout = drive[:5]
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    with open(os.path.join(jout, "metrics.jsonl")) as fh:
        jrows = [json.loads(line) for line in fh]
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert sorted(r) == sorted(j)
        for k in j:
            if k in ("frame_seconds", "mpix_per_s") or isinstance(j[k], bool):
                continue
            assert np.isfinite(r[k]), (k, r)
            np.testing.assert_allclose(r[k], j[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert any("tex_loss_im" in r for r in rows) and not any("tex_ssim" in k for r in rows for k in r)


def test_drive_resumes_as_a_no_op_and_no_resume_exits(drive, capsys):
    tree, _, _, out, _, argv = drive
    stamps = {f: os.path.getmtime(os.path.join(out, "000002", f)) for f in ("face.obj", "face.png")}
    blend.reset_launches()
    again = main(argv + ["--device", "cpu"])
    assert again is not None and sum(blend.LAUNCHES.values()) == 0
    assert {f: os.path.getmtime(os.path.join(out, "000002", f)) for f in ("face.obj", "face.png")} == stamps
    assert main(argv + ["--device", "cpu", "--no_resume"]) is None
    assert "already exists and --no_resume given" in capsys.readouterr().out


def test_report_progress_matches_jax(drive, tmp_path):
    """The port's ``report_progress`` on the tiled renderer against JAX's, on
    the drive's final parameters and frame-2 targets: the saved PNGs (bytes
    within 1) and the returned PSNR (rtol 1e-5)."""
    tree, trainer, _, _, _ = drive[:5]
    params = {k: v.detach() for k, v in trainer.state.params.items()}
    images = torch.as_tensor(tree.images[(2, False)].astype(np.float32) / 255.0)
    cams = make_camera_ring(2, width=32, height=48, distance=2.0, device="cpu")
    names = ["a", "b"]
    got = report_progress(params, lambda rv, c: render_gaussians_tiled(rv, c), cams, images, names, ["b", "a", "x"],
                          str(tmp_path / "port"), 2, 5)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want = j_report_progress(jparams, lambda rv, c: j_tiled(rv, c), j_ring(2, width=32, height=48, distance=2.0),
                             jnp.asarray(images.numpy()), names, ["b", "a", "x"], str(tmp_path / "jax"), 2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("visa_5.png", "visb_5.png"):
        a = _decoded(str(tmp_path / "port" / "000002" / name))
        b = _decoded(str(tmp_path / "jax" / "000002" / name))
        assert a.shape == (48, 32, 3) and np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.01
