"""The tile blend's share of its roofline, forward and backward together:
the bound time of every call into the port's K1 and K2 entries
(``benchmark/work/blend.py``, counted for the call's view) over the device
time of the kernels launched inside the ``blend_fwd`` and ``blend_bwd``
spans. A call's view is the one whose frozen binning (from the
``dense_binnings`` span) holds the tile counts the call was given."""

from benchmark.reference import render as R
from benchmark.work.blend import view_work


def _views_of(trace):
    at = {}
    for call in trace.calls.get("dense_binnings", []):
        for v, b in enumerate(call.get("result") or []):
            at[b.tile_count.data_ptr()] = v
            if getattr(b, "compact", None) is not None:
                at[b.compact.count.data_ptr()] = v
    return at


def read(trace):
    fwd, bwd = trace.calls.get("blend_fwd", []), trace.calls.get("blend_bwd", [])
    ns = sum(op.dur_ns for op in trace.span_ops("blend_fwd", "blend_bwd"))
    at = _views_of(trace)
    views = [at.get(c["args"][0]) for c in fwd + bwd]
    if not fwd or ns <= 0 or None in views:
        return None
    g = trace.context["dense_gaussians"]()
    rig, span = trace.context["scene"].dense_rig, trace.context["config"]["max_span"]
    work = {}
    for v in set(views):
        cam = R.rig_camera(rig, v, g["means"].device)
        xy, depth, conic, radius, visible = R.project(g["means"], g["quats"], g["scales"], cam)
        bins = R.bin_tiles(xy, depth, radius, visible, cam.width, cam.height, span)
        work[v] = view_work(bins, xy, conic, g["opacity"])
    bound = sum(work[v].fwd_bound_s() for v in views[: len(fwd)])
    bound += sum(work[v].bwd_bound_s() for v in views[len(fwd):])
    return 100.0 * bound / (ns / 1e9)
