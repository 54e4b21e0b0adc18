"""``python -m topo4d_tpu_torch.validate {fabricate,score,headline,long,tex8k} ...``

The positional arguments are those of the JAX scripts each sub-command
replaces; every sub-command takes ``--device`` (default cuda, which raises
without a card). ``headline``, ``long`` and ``tex8k`` take ``--schedule
"FLAGS"``, CLI flags appended to each fit's arguments (the last of a
repeated flag wins), to cut the schedule of a small run.

  fabricate <root> [views=24] [frames=800] [rows=92] [cols=90] [work_w=375]
            [work_h=512] [ratio=2] [motion=0.004] [dense,seam]
  score     <root> <validate_out_root> [frames=4]
  headline  <root> <out_root> [frames=4]
  long      <root> <out_root> [frames=800] [motion=0.004] [skip_modes=]
            [batched0_frames=frames]
  tex8k     <root> <out_root> [frames=3] [--verify-only]
"""

from __future__ import annotations

import argparse
import shlex
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m topo4d_tpu_torch.validate",
                                description="Reference-scale validation of topo4d_tpu_torch.")
    sub = p.add_subparsers(dest="command", required=True)

    def command(name, help_, schedule=True):
        c = sub.add_parser(name, help=help_)
        c.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the renders and fits run (cuda raises without a card)")
        if schedule:
            c.add_argument("--schedule", default="", metavar="FLAGS",
                           help="CLI flags appended to each fit's arguments, e.g. \"-ion 12 -on 8 -lf 4\"")
        return c

    c = command("fabricate", "write a validation dataset (scripts/fabricate_fast.py)", schedule=False)
    c.add_argument("root")
    for name, kind, default in (("views", int, 24), ("frames", int, 800), ("rows", int, 92), ("cols", int, 90),
                                ("work_w", int, 375), ("work_h", int, 512), ("ratio", int, 2),
                                ("motion", float, 0.004), ("flags", str, "")):
        c.add_argument(name, type=kind, nargs="?", default=default)
    c = command("score", "the common metric of a headline run (scripts/eval_headline_common.py)", schedule=False)
    c.add_argument("root")
    c.add_argument("vroot")
    c.add_argument("frames", type=int, nargs="?", default=4)
    c = command("headline", "headline, batched0 and parity fits compared (scripts/validate_headline.py)")
    c.add_argument("root")
    c.add_argument("out_root")
    c.add_argument("frames", type=int, nargs="?", default=4)
    c = command("long", "the long-horizon run and its drift (scripts/run_long_r04.py)")
    c.add_argument("root")
    c.add_argument("out_root")
    c.add_argument("frames", type=int, nargs="?", default=800)
    c.add_argument("motion", type=float, nargs="?", default=0.004)
    c.add_argument("skip_modes", nargs="?", default="")
    c.add_argument("batched0_frames", type=int, nargs="?", default=None)
    c = command("tex8k", "the 8K texture run with fixed-view PSNR and UV seams (scripts/run_tex8k_r05.py)")
    c.add_argument("root")
    c.add_argument("out_root")
    c.add_argument("frames", type=int, nargs="?", default=3)
    c.add_argument("--verify-only", action="store_true", help="check an existing run's outputs")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from topo4d_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    schedule = shlex.split(getattr(args, "schedule", ""))
    if args.command == "fabricate":
        from topo4d_tpu_torch.validate.fabricate import fabricate

        fabricate(args.root, args.views, args.frames, args.rows, args.cols, args.work_w, args.work_h, args.ratio,
                  args.motion, dense_tree="dense" in args.flags, uv_seam="seam" in args.flags, device=device)
    elif args.command == "score":
        from topo4d_tpu_torch.validate import score

        score.main(args.root, args.vroot, args.frames, device)
    elif args.command == "headline":
        from topo4d_tpu_torch.validate import headline

        headline.main(args.root, args.out_root, args.frames, device, schedule)
    elif args.command == "long":
        from topo4d_tpu_torch.validate import long_run

        long_run.main(args.root, args.out_root, args.frames, args.motion, args.skip_modes.split(","),
                      args.batched0_frames, device, schedule)
    else:
        from topo4d_tpu_torch.validate import tex8k

        tex8k.main(args.root, args.out_root, args.frames, args.verify_only, device, schedule)
    return 0


if __name__ == "__main__":
    sys.exit(main())
