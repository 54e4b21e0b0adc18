"""Checkpoints: the reference's ``params.npz`` and a full resume state
(``pipeline/checkpoint.py``, the pickle backend).

The reference only saves: it stacks per-frame parameter snapshots into
``params.npz``, frame 0 with every non-dense parameter and later frames
with ``DELTA_KEYS`` only (helpers.py:160-178). The resume checkpoint adds
the optimizer moments, the temporal priors and the frame index. Tensors are
stored as NumPy arrays, so a checkpoint loads without a card.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

DELTA_KEYS = ("means3D", "rgb_colors", "unnorm_rotations")


def tree_map(fn, tree):
    """``fn`` on every leaf of a nest of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy(tree):
    """Tensors of a nest -> NumPy arrays on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, tree)


def to_torch(tree, device):
    """NumPy arrays of a nest -> tensors on ``device`` (the inverse of ``to_numpy``)."""
    return tree_map(lambda x: torch.as_tensor(x, device=device) if isinstance(x, np.ndarray) else x, tree)


def clone(tree):
    """Tensors of a nest -> copies on their device, a snapshot that later
    steps cannot change."""
    return tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, tree)


def params_snapshot(params: Dict[str, torch.Tensor], is_initial_timestep: bool) -> Dict[str, np.ndarray]:
    """Per-frame snapshot (reference ``params2cpu``, helpers.py:160-166)."""
    if is_initial_timestep:
        return {k: to_numpy(v) for k, v in params.items() if not k.startswith("dense")}
    return {k: to_numpy(params[k]) for k in DELTA_KEYS}


def save_params(output_params: List[Dict[str, np.ndarray]], out_dir: str) -> None:
    """Stack the snapshots into params.npz (reference helpers.py:169-178):
    keys of every frame stacked, frame-0-only keys as they are."""
    to_save = {}
    for k in output_params[0].keys():
        if len(output_params) > 1 and k in output_params[1]:
            to_save[k] = np.stack([p[k] for p in output_params])
        else:
            to_save[k] = output_params[0][k]
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params"), **to_save)


def load_params(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_resume(
    out_dir: str,
    frame: int,
    state,
    priors,
    first_frame_attrs: Optional[Dict],
    output_params: List[Dict[str, np.ndarray]],
    texture_state=None,
) -> None:
    """Write the resume checkpoint atomically.

    The snapshot history goes to an append-only side stream
    (``snapshots.pkl``), since pickling the whole history every frame costs
    O(frames^2) over a long sequence. ``snapshots.pkl.count`` records how
    many records, and how many bytes, of the stream are valid, and
    ``resume.pkl`` how many records its frame needs. A crash between the
    append and the count's replace leaves an orphan record past that
    prefix: the load never reads it, and the next save cuts it off before
    it appends.
    """
    os.makedirs(out_dir, exist_ok=True)
    spath = os.path.join(out_dir, "snapshots.pkl")
    cpath = spath + ".count"
    n_existing, n_bytes = 0, 0
    if os.path.exists(cpath) and os.path.exists(spath):
        try:
            with open(cpath) as fh:
                n_existing, n_bytes = (int(x) for x in fh.read().split())
        except ValueError:
            n_existing, n_bytes = 0, 0
    if n_existing > len(output_params):
        n_existing, n_bytes = 0, 0  # a stale stream from an older run: rewrite it
    with open(spath, "r+b" if n_existing else "wb") as fh:
        fh.seek(n_bytes)
        fh.truncate()
        for snap in output_params[n_existing:]:
            pickle.dump(snap, fh)
        n_bytes = fh.tell()
    tmp = cpath + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(f"{len(output_params)} {n_bytes}")
    os.replace(tmp, cpath)

    payload = {
        "frame": frame,
        "state": to_numpy(state),
        "priors": to_numpy(priors),
        "first_frame_attrs": to_numpy(first_frame_attrs),
        "n_snapshots": len(output_params),
        "texture_state": to_numpy(texture_state),
    }
    tmp = os.path.join(out_dir, "resume.pkl.tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(payload, fh)
    os.replace(tmp, os.path.join(out_dir, "resume.pkl"))


def load_resume(out_dir: str):
    """The resume payload with its ``output_params`` read back from the
    snapshot stream, or None. Reads only files this package wrote."""
    path = os.path.join(out_dir, "resume.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    n = payload.pop("n_snapshots", 0)
    snaps = []
    spath = os.path.join(out_dir, "snapshots.pkl")
    if n and os.path.exists(spath):
        with open(spath, "rb") as fh:
            for _ in range(n):
                snaps.append(pickle.load(fh))
    payload["output_params"] = snaps
    return payload


def write_loss_json(out_dir: str, losses_enabled: Dict, weights: Dict) -> None:
    """One-shot loss config dump (reference helpers.py:826-833)."""
    path = os.path.join(out_dir, "loss.json")
    if os.path.exists(path):
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as fh:
        json.dump([losses_enabled, weights], fh, indent=4)


ORBAX_DIR = "resume_orbax"


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Leaves of a nest of dicts, lists and NamedTuples -> ``out[path]``
    as CPU tensors; an empty dict or None adds nothing."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        x = tree.detach().cpu() if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
        out[prefix] = x.contiguous()


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    """``_flatten``'s paths -> nested dicts of NumPy arrays (a list's items
    under their decimal indices)."""
    root: Dict = {}
    for path, x in flat.items():
        node = root
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x.numpy()
    return root


def _as_list(d: Optional[Dict]) -> List:
    return [] if not d else [d[k] for k in sorted(d, key=int)]


def save_resume_orbax(
    out_dir: str,
    frame: int,
    state,
    priors,
    first_frame_attrs: Optional[Dict],
    output_params: List[Dict[str, np.ndarray]],
    texture_state=None,
) -> None:
    """The resume payload of ``save_resume`` as a ``torch.distributed.checkpoint``
    directory ``<out_dir>/resume_orbax`` (the "orbax" backend,
    ``pipeline/checkpoint.py:149``): the snapshot history whole, every leaf
    a tensor under its path. Host 0 saves alone, so the save enters no
    collective (``no_dist``); it writes a sibling directory and renames it
    into place."""
    import shutil

    import torch.distributed.checkpoint as dcp

    flat: Dict[str, torch.Tensor] = {"frame": torch.tensor(frame, dtype=torch.int64)}
    for name, tree in (("state", state), ("priors", priors), ("first_frame_attrs", first_frame_attrs),
                       ("output_params", output_params), ("texture_state", texture_state)):
        _flatten(tree, name, flat)
    path = os.path.abspath(os.path.join(out_dir, ORBAX_DIR))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    dcp.save(flat, storage_writer=dcp.FileSystemWriter(tmp, thread_count=1), no_dist=True)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_resume_orbax(out_dir: str):
    """The payload ``save_resume_orbax`` wrote, its states rebuilt as
    ``TrainState``, ``GeometryPriors`` and ``TextureState`` with NumPy
    leaves, or None (``pipeline/checkpoint.py:172``). Reads only
    checkpoints this package wrote."""
    import torch.distributed.checkpoint as dcp

    from topo4d_tpu_torch.losses.temporal import TemporalPriors
    from topo4d_tpu_torch.opt.adam import AdamState
    from topo4d_tpu_torch.opt.step import GeometryPriors, TrainState
    from topo4d_tpu_torch.texture.dense import TextureState

    path = os.path.abspath(os.path.join(out_dir, ORBAX_DIR))
    if not os.path.isdir(path):
        return None
    reader = dcp.FileSystemReader(path)
    flat = {
        k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
        for k, m in reader.read_metadata().state_dict_metadata.items()
    }
    dcp.load(flat, storage_reader=reader, no_dist=True)
    p = _unflatten(flat)

    def adam(d):
        return AdamState(step={k: int(v) for k, v in d["step"].items()}, mu=d["mu"], nu=d["nu"])

    s = p["state"]
    state = TrainState(params=s["params"], opt=adam(s["opt"]), max_2d_radius=s["max_2d_radius"])
    pr = dict(p["priors"])
    pr["temporal"] = TemporalPriors(**pr["temporal"])
    tex = p.get("texture_state")
    return {
        "frame": int(p["frame"]),
        "state": state,
        "priors": GeometryPriors(**pr),
        "first_frame_attrs": p.get("first_frame_attrs") or None,
        "output_params": [dict(d) for d in _as_list(p.get("output_params"))],
        "texture_state": TextureState(params=tex["params"], opt=adam(tex["opt"])) if tex else None,
    }
