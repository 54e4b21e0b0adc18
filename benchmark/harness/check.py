"""What decides ``correct``: the program's first four dense steps against
the plain reference's (``reference/step.py``).

Set-up drives the trainer the window uses through ``fit_frame_texture``
with the configuration's own log frequency: frame 0 for one step (a
logged step, ``texture_step``), then frame 1 for three (step 0 logged,
steps 1-2 through ``texture_multi_step``, as the window runs all but a few
of its steps). From the program it reads the logged steps' ``loss_total``
(its metrics rows), the first gradient as Adam holds it after one step
(mu / (1 - beta1)), the parameters' change over the four steps (the start
worked back from the state after one step by Adam's own update), and
Adam's step count of each leaf. The reference runs the same four steps on
the same inputs after the window has closed. Compared, each against its
limit in the configuration file:

- ``loss_gap``: the largest |program - reference| / |reference| of the
  logged steps' losses;
- ``grad_gap``: over the leaves, the largest gap between the two first
  gradients' norms, over the larger of the reference's norm of that leaf
  and of the median leaf;
- ``change_gap``: the same for the norms of the change after the four
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a rotation of an isotropic Gaussian moves under
  Adam by round-off alone);
- ``step_count_gap``: the largest gap between a leaf's Adam step count and
  the reference's number of steps (exact: limit 0).
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from benchmark.harness import program

B1, B2, EPS = 0.9, 0.999, 1e-15
KEEP_SHARE = 1e-3
CHECK_STEPS = ((0, 1), (1, 3))  # (frame, steps): four steps over two frames


def program_readings(trainer, heads, targets, names) -> dict:
    """Run the check's steps through the trainer -> its readings. Leaves
    the trainer after frame 1, ready for the window. The log frequency has
    to exceed the steps of a frame for the multi-step to run."""
    sched = trainer.cfg.schedule
    saved = sched.dense_opt_num
    lrs = dict(trainer.cfg.lrs.dense)
    losses, grads, start, first = [], None, None, 0
    try:
        for frame, steps in CHECK_STEPS:
            sched.dense_opt_num = steps
            program.set_geometry(trainer, heads[frame])
            before = len(trainer.metrics_log)
            trainer.fit_frame_texture(frame, program.frame_data(targets[frame], names))
            losses += [[first + int(r["iter"]), float(r["tex_loss_total"])]
                       for r in trainer.metrics_log[before:] if "tex_loss_total" in r]
            first += steps
            if grads is None:
                st = trainer.texture_state
                grads = {k: float((st.opt.mu[k].double() / (1 - B1)).norm()) for k in st.opt.mu}
                start = {k: adam_before(st.params[k], st.opt.mu[k], st.opt.nu[k], lrs[k]) for k in st.params}
    finally:
        sched.dense_opt_num = saved
    st = trainer.texture_state
    return {"losses": losses, "grad_norms": grads,
            "change_norms": {k: float((st.params[k].double() - start[k]).norm()) for k in start},
            "adam_steps": {k: int(n) for k, n in st.opt.step.items()}}


def logged_steps() -> list:
    """The check's steps that the program logs: each frame's first."""
    firsts = [0]
    for _, steps in CHECK_STEPS[:-1]:
        firsts.append(firsts[-1] + steps)
    return firsts


def as_program(ref: dict) -> dict:
    """The reference's readings in the program's form: the losses of the
    steps the program logs, a step count for each leaf. A control put in
    the program's place is read so."""
    return {**ref, "losses": [[i, ref["losses"][i]] for i in logged_steps()],
            "adam_steps": {k: ref["adam_steps"] for k in ref["grad_norms"]}}


def adam_before(p1, mu, nu, lr: float) -> torch.Tensor:
    """The parameters before Adam's first step, from those after it and its moments."""
    step = (lr / (1 - B1)) * mu.double() / (torch.sqrt(nu.double() / (1 - B2)) + EPS)
    return p1.double() + step


def _gap(a: float, b: float, scale: float) -> float:
    num = abs(a - b)
    return 0.0 if num == 0.0 else num / max(scale, 1e-300)


def _worst(gaps) -> float:
    gaps = list(gaps)
    return max(gaps) if all(g == g and g != float("inf") for g in gaps) else float("inf")


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """-> {loss_gap, grad_gap, change_gap, step_count_gap}. A reading the
    program lacks reads as infinitely far. ``prog["losses"]`` holds [step,
    loss] pairs of the logged steps, ``ref["losses"]`` every step's loss."""
    logged = [i for i, _ in prog["losses"]]
    if (not logged or min(logged) < 0 or max(logged) >= len(ref["losses"])
            or set(prog["grad_norms"]) != set(ref["grad_norms"]) or set(prog["adam_steps"]) != set(ref["grad_norms"])):
        return {k: float("inf") for k in ("loss_gap", "grad_gap", "change_gap", "step_count_gap")}
    loss = _worst(_gap(p, ref["losses"][i], abs(ref["losses"][i])) for i, p in prog["losses"])
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = _worst(_gap(prog["grad_norms"][k], g, max(g, g_med)) for k, g in g_ref.items())
    kept = [k for k, g in g_ref.items() if g >= KEEP_SHARE * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[k] for k in kept)
    change = _worst(_gap(prog["change_norms"][k], c_ref[k], max(c_ref[k], c_med)) for k in kept)
    steps = float(max(abs(n - ref["adam_steps"]) for n in prog["adam_steps"].values()))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "step_count_gap": steps}
