"""The program under test, ``topo4d_tpu_torch``, set up from the benchmark's
scene and configuration. The port is imported here and nowhere else in
the harness, and only when a run starts."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


class Source:
    """What the trainer reads of a sequence: its two rigs and view names."""

    def __init__(self, cameras, cameras_full, num_views: int):
        self.cameras, self.cameras_full, self.num_views = cameras, cameras_full, num_views
        self.view_names = [f"view{v:02d}" for v in range(num_views)]


def program_config(config: dict, traffic: dict):
    """The port's ``Config`` for this configuration and traffic."""
    from topo4d_tpu_torch.config import Config

    cfg = Config()
    cfg.data.output_dir = os.path.join(tempfile.gettempdir(), "topo4d_benchmark_out")
    cfg.data.log_views = []
    cfg.data.down_ratio = config["down_ratio"]
    cfg.data.dense_down_ratio = config["dense_down_ratio"]
    cfg.texture.gen_tex = True
    cfg.texture.density = config["density"]
    cfg.texture.tex_res = config["tex_res"]
    cfg.raster.max_span = config["max_span"]
    cfg.schedule.views_per_step = config["views_per_step"]
    cfg.schedule.dense_opt_num = config["dense_opt_num"]
    cfg.schedule.dense_log_freq = config["dense_log_freq"]
    cfg.lrs.dense = dict(config["dense_lrs"])
    for k, v in config["dense_weights"].items():
        setattr(cfg.dense_weights, k, v)
    apply_overrides(cfg, traffic.get("program", {}))
    return cfg


def apply_overrides(cfg, overrides: dict) -> dict:
    """Set dotted ``Config`` fields (e.g. "schedule.fuse_views") -> the values they replaced."""
    replaced = {}
    for path, value in overrides.items():
        *parents, leaf = path.split(".")
        obj = cfg
        for name in parents:
            obj = getattr(obj, name)
        if not hasattr(obj, leaf):
            raise ValueError(f"the port's Config has no field {path!r}")
        replaced[path] = getattr(obj, leaf)
        setattr(obj, leaf, value)
    return replaced


def program_rig(rig, device):
    from topo4d_tpu_torch.core.camera import make_camera

    k = np.zeros((rig.w2c.shape[0], 3, 3), np.float32)
    k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = rig.fx, rig.fy, rig.cx, rig.cy, 1.0
    return make_camera(k, rig.w2c, rig.width, rig.height, device=device)


def build_trainer(scene, config: dict, traffic: dict, device):
    """The port's ``Trainer`` over the scene's mesh and rigs, its geometry
    state holding the template head with the scene's colours."""
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.topology.obj_io import MeshObj
    from topo4d_tpu_torch.topology.regions import FacialRegions

    cfg = program_config(config, traffic)
    mesh = MeshObj(vertices=scene.verts, uvs=scene.uvs, faces=scene.faces, uv_faces=scene.uv_faces)
    params_np, statics = build_scene(mesh, FacialRegions.from_dict(scene.regions), cfg, num_views=config["views"])
    source = Source(program_rig(scene.work_rig, device), program_rig(scene.dense_rig, device), config["views"])
    trainer = Trainer(cfg, source, params_np, statics, device=device)
    set_geometry(trainer, scene.verts, scene.colors)
    return trainer


def set_geometry(trainer, head: np.ndarray, colors=None) -> None:
    """Put the benchmark's head (and colours) into the trainer's geometry state."""
    p = dict(trainer.state.params)
    p["means3D"] = torch.as_tensor(head, dtype=torch.float32, device=trainer.device)
    if colors is not None:
        p["rgb_colors"] = torch.as_tensor(colors, dtype=torch.float32, device=trainer.device)
    trainer.state = trainer.state._replace(params=p)


def frame_data(views, names):
    """A frame's targets as a loader hands them over: uint8 views on the host."""
    from topo4d_tpu_torch.pipeline.data import FrameData, HostViews

    return FrameData(images=HostViews(pixels=list(views), turns=[0] * len(views)), masks=None, view_names=names)
