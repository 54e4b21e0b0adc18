"""Command-line entry point (``topo4d_tpu/cli.py``; reference train.py:759-786).

Usage:
  python -m topo4d_tpu_torch -id <root> -s <seq> -od <out> [--gen_tex] ... [--device cpu]

Every flag of ``python -m topo4d_tpu.cli`` is kept, with its meaning:
``--config`` loads a JSON config (``Config.from_json``, which also reads the
JAX CLI's ``config.json``), and flags not passed leave its values alone.
``--backend pallas`` (the default, the JAX name) runs the hand-written
kernels on the card, their plain versions under ``--device cpu``;
``tiled`` and ``oracle`` run the plain PyTorch renderers on the device.
One flag is added, ``--device {cuda,cpu}`` (default cuda, which raises
without a card). ``--interpret`` (Pallas's interpreter) raises: the CPU run
is ``--device cpu``.

On N cards: ``torchrun --nproc_per_node=N -m topo4d_tpu_torch ...``, or
the JAX launch variables
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) in
each process (``parallel/multihost.py``). Each rank runs on
``cuda:<LOCAL_RANK>`` over NCCL (``--device cpu``: gloo); rank 0 alone
writes.
"""

from __future__ import annotations

import argparse
import os

from topo4d_tpu_torch.config import Config


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Topo4D sequence fitting (PyTorch / CUDA)")
    p.add_argument("-e", "--exp", type=str, default="exp_op1", help="Experiment name.")
    p.add_argument("-s", "--seq", type=str, default="seq_01", help="Input sequence name.")
    p.add_argument("-id", "--input_dir", type=str, default="", help="Root of inputs ($input_dir/$seq).")
    p.add_argument("-od", "--output_dir", type=str, default="output", help="Root of outputs ($output_dir/$exp/$seq).")
    p.add_argument("-did", "--dense_input_dir", type=str, default="", help="Root of full-resolution inputs.")
    p.add_argument("-fn", "--frame_num", type=int, default=800)
    p.add_argument("-t", "--gen_tex", action="store_true")
    p.add_argument("-tr", "--tex_res", type=int, default=8192)
    p.add_argument("-dn", "--density", type=int, default=30)
    p.add_argument("-dr", "--down_ratio", type=int, default=8)
    p.add_argument("-ddr", "--dense_down_ratio", type=int, default=1)
    p.add_argument("-ion", "--init_opt_num", type=int, default=7000)
    p.add_argument("-on", "--opt_num", type=int, default=1100)
    p.add_argument("-don", "--dense_opt_num", type=int, default=301)
    p.add_argument("-lf", "--log_freq", type=int, default=500)
    p.add_argument("-dlf", "--dense_log_freq", type=int, default=300)
    p.add_argument("-lv", "--log_views", type=str, nargs="*", default=["K98707293"])
    p.add_argument("-cf", "--ckp_freq", type=int, default=5)
    p.add_argument("--config", type=str, default="", help="JSON config file overriding all defaults.")
    p.add_argument("--backend", type=str, default="pallas", choices=["pallas", "tiled", "oracle"],
                   help="pallas: the blend kernels (their plain versions under --device cpu); tiled, oracle: the "
                   "plain PyTorch renderers.")
    p.add_argument("--interpret", action="store_true",
                   help="A Pallas option of the JAX CLI; raises here (use --device cpu).")
    p.add_argument("--views_per_step", type=int, default=1, help="1 = reference parity; 0 = all views batched.")
    p.add_argument("--track_rebin_freq", type=int, default=-1,
                   help="Geometry segments reuse per-view binnings for up to this many steps (pallas; 0 = a "
                   "fresh binning every render, the reference's semantics). -1 = auto: 0 in parity mode, 25 in "
                   "the batched all-views mode.")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--no_mask", action="store_true", help="Disable face-parsing masks even if configured on.")
    p.add_argument("--regions_pkl", type=str, default="",
                   help="Path to facial_regions.pkl (default: $input_dir/assets/facial_regions.pkl, falling back "
                   "to ./assets/facial_regions.pkl).")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Where the fit runs (cuda raises without a card).")
    # flags the user did not pass must not clobber --config values: value
    # flags get a None sentinel (their documented defaults live in
    # config.py); store_true flags apply only when given
    keep = {"help", "config", "gen_tex", "interpret", "no_resume", "no_mask", "regions_pkl", "device"}
    for action in p._actions:
        if action.dest not in keep:
            action.default = None
    return p


def config_from_args(args) -> Config:
    if args.interpret:
        raise ValueError("--interpret runs the JAX package's Pallas kernels in the interpreter; here pass "
                         "--device cpu to run on the CPU")
    if args.config:
        with open(args.config) as fh:
            cfg = Config.from_json(fh.read())
    else:
        cfg = Config()
    d, s, tx = cfg.data, cfg.schedule, cfg.texture

    def put(obj, field, val):
        if val is not None:
            setattr(obj, field, val)

    put(d, "exp", args.exp)
    put(d, "seq", args.seq)
    put(d, "input_dir", args.input_dir)
    put(d, "output_dir", args.output_dir)
    put(d, "dense_input_dir", args.dense_input_dir or None)
    if not d.dense_input_dir:
        d.dense_input_dir = d.input_dir
    put(d, "down_ratio", args.down_ratio)
    put(d, "dense_down_ratio", args.dense_down_ratio)
    if args.log_views is not None:
        d.log_views = list(args.log_views)
    put(s, "frame_num", args.frame_num)
    put(s, "init_opt_num", args.init_opt_num)
    put(s, "opt_num", args.opt_num)
    put(s, "dense_opt_num", args.dense_opt_num)
    put(s, "log_freq", args.log_freq)
    put(s, "dense_log_freq", args.dense_log_freq)
    put(s, "ckp_freq", args.ckp_freq)
    put(s, "views_per_step", args.views_per_step)
    if args.gen_tex:
        tx.gen_tex = True
    put(tx, "tex_res", args.tex_res)
    put(tx, "density", args.density)
    put(cfg.raster, "backend", args.backend)
    put(cfg.raster, "track_rebin_freq", args.track_rebin_freq)
    if args.no_mask:
        d.use_mask = False
        d.use_mask_dense = False  # "even if configured on" covers both
    if args.regions_pkl:
        d.regions_pkl = args.regions_pkl
    else:
        cand = os.path.join(d.input_dir, "assets", "facial_regions.pkl")
        if os.path.exists(cand):
            d.regions_pkl = cand
    return cfg


def main(argv=None):
    """Fit the sequence the arguments name -> the ``Trainer`` that ran (None
    when the output exists and ``--no_resume`` was given)."""
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)

    # several processes: join the process group before the output
    # directory is touched, each rank on its card (a no-op otherwise)
    from topo4d_tpu_torch.parallel.multihost import initialize_multihost, is_host0, rank_device

    initialize_multihost(device=args.device)
    device = rank_device(args.device)
    out_dir = os.path.join(cfg.data.output_dir, cfg.data.exp, cfg.data.seq)
    if os.path.exists(out_dir) and args.no_resume:
        print(
            f"Experiment '{cfg.data.exp}' for sequence '{cfg.data.seq}' "
            f"already exists and --no_resume given. Exiting."
        )
        return None

    from topo4d_tpu_torch.pipeline.data import DiskSequence, read_image
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.topology.obj_io import load_obj, sample_vertex_colors
    from topo4d_tpu_torch.topology.regions import load_facial_regions

    source = DiskSequence(cfg, device=device)
    seq_dir = os.path.join(cfg.data.input_dir, cfg.data.seq)
    mesh = load_obj(os.path.join(seq_dir, cfg.data.startup_mesh))
    regions = load_facial_regions(cfg.data.regions_pkl)

    vertex_colors = None
    tex_path = os.path.join(seq_dir, "face_v5.png")
    if os.path.exists(tex_path):
        tex = read_image(tex_path)
        vertex_colors = sample_vertex_colors(tex, mesh.num_vertices, mesh.faces, mesh.uv_faces, mesh.uvs) / 255.0

    params, statics = build_scene(
        mesh, regions, cfg, vertex_colors=vertex_colors, trans_g=source.trans_g, num_views=source.num_views,
    )
    trainer = Trainer(cfg, source, params, statics, device=device)
    if is_host0():  # the effective config beside the outputs
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
    trainer.run(resume=not args.no_resume)
    return trainer
