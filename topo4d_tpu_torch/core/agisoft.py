"""Agisoft Metashape calibration loader (host-side NumPy; ``core/agisoft.py``).

The reference's camera ingestion (camera.py:14-205): XML parsing of
sensors/cameras/components, the resize-factor intrinsic scaling and the
90-degree portrait-sensor intrinsic swap, the component global transform,
the OpenGL -> COLMAP axis flip, per-view z-rotation, and the Tsai ->
OpenCV radial-distortion conversion (distortion is carried through but —
like the reference — not applied on the Gaussian render path).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, Tuple

import numpy as np
import torch


def convert_distortion_parms(
    k1: float, k2: float, fl: float, fx: float, fy: float,
    width: int, height: int,
) -> Tuple[float, float]:
    """Tsai undistortion -> OpenCV distortion coefficients.

    Reference camera.py:14-27: sample 100 radii, invert the mapping by
    least squares.
    """
    big_k1 = k1 * (fl**2.0)
    big_k2 = k2 * (fl**4.0)
    r = 0.01 * np.arange(1, 101) * (
        ((width / fx) ** 2.0 + (height / fy) ** 2.0) ** 0.5
    )
    undist = r * (1 + big_k1 * r**2.0 + big_k2 * r**4.0)
    factors = r / undist - 1.0
    a = np.stack([undist**2.0, undist**4.0], axis=1)
    sol, *_ = np.linalg.lstsq(a, factors[:, None], rcond=None)
    return float(sol[0, 0]), float(sol[1, 0])


def extract_intrinsics(
    sensors_node, sensor_id: int, resize_factor: int = 1, rot: int = 0
):
    """Sensor intrinsics -> (radial_distortion, K (3,3), image_size (h, w)).

    Reference camera.py:45-115, including the rotated-sensor branch that
    swaps the principal point into the rotated frame. PARITY QUIRK kept
    deliberately: the reference's branch (camera.py:102-107) applies the
    +90 (CCW) principal-point mapping for ANY rot != 0 — rot=-1 sensors
    inherit the same sign-agnostic swap the reference's calibrations were
    fit against; "fixing" it would break parity with reference datasets.
    """
    f = cx = cy = None
    k1 = k2 = 0.0
    pw = ph = 1.0
    img_w = img_h = None
    for sensor in sensors_node.findall("sensor"):
        if int(sensor.get("id")) != sensor_id:
            continue
        for prop in sensor.findall("property"):
            if prop.get("name") == "pixel_width":
                pw = float(prop.get("value"))
            if prop.get("name") == "pixel_height":
                ph = float(prop.get("value"))
        res = sensor.find("resolution")
        img_w = int(res.get("width"))
        img_h = int(res.get("height"))
        calib = sensor.find("calibration")
        f = float(calib.find("f").text)
        if calib.find("cx") is not None:
            cx = img_w / 2.0 + float(calib.find("cx").text)
            cy = img_h / 2.0 + float(calib.find("cy").text)
        else:
            cx = img_w / 2.0
            cy = img_h / 2.0
        if calib.find("k1") is not None:
            k1 = float(calib.find("k1").text)
        if calib.find("k2") is not None:
            k2 = float(calib.find("k2").text)
        break
    if f is None:
        raise ValueError(f"sensor {sensor_id} not found")

    if resize_factor != 1:
        img_w = math.floor(img_w / resize_factor)
        img_h = math.floor(img_h / resize_factor)
        f /= resize_factor
        cx /= resize_factor
        cy /= resize_factor

    dk1, dk2 = convert_distortion_parms(k1, k2, f * pw, f, f, img_w, img_h)
    radial = np.array([dk1, dk2])
    if rot != 0:
        intrinsics = np.array(
            [[f, 0, cy], [0, f, img_w - cx], [0, 0, 1.0]]
        )
        img_size = np.array([img_w, img_h])  # rotated: (h, w) swapped
    else:
        intrinsics = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        img_size = np.array([img_h, img_w])
    return radial, intrinsics, img_size


def extract_extrinsics(
    cameras_node, components_node, img_name: str, rot: int = 0
):
    """Camera extrinsics -> (w2c (3,4) COLMAP, center, view_dir, sensor_id,
    trans_g (4,4) component global transform).

    Reference camera.py:118-170: per-view transform with OpenGL column
    flip, optional z-rotation for portrait sensors, OpenGL->COLMAP axis
    flip.
    """
    trans_g = np.eye(4)
    component = components_node.find("component") if components_node is not None else None
    if component is not None and component.find("transform") is not None:
        rot_g = np.array(
            [float(v) for v in component.find("transform").find("rotation").text.split()]
        ).reshape(3, 3)
        t_g = np.array(
            [float(v) for v in component.find("transform").find("translation").text.split()]
        )
        trans_g = np.eye(4)
        trans_g[:3, :3] = rot_g
        trans_g[:3, 3] = t_g

    node = None
    sensor_id = None
    for cam in cameras_node.findall("camera"):
        if cam.get("label") == img_name:
            sensor_id = int(cam.get("sensor_id"))
            node = cam
            break
    if node is None:
        raise ValueError(f"camera {img_name} not found")

    transform = np.array(
        [float(v) for v in node.find("transform").text.split()]
    ).reshape(4, 4)
    transform[:3, 1:3] *= -1  # camera-to-world, OpenGL axes

    theta = -1 * rot * 90 * np.pi / 180
    c, s = np.cos(theta), np.sin(theta)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    transform[:3, :3] = transform[:3, :3] @ rz

    ext_gl = np.linalg.inv(transform)[:3, :4]
    flip = np.diag([1.0, -1.0, -1.0])  # OpenGL -> COLMAP (y, z flip)
    ext = np.eye(4)
    ext[:3, :3] = flip @ ext_gl[:3, :3]
    ext[:3, 3] = flip @ ext_gl[:3, 3]

    r = ext[:3, :3]
    t = ext[:3, 3]
    center = -r.T @ t
    view_dir = r.T @ np.array([0.0, 0.0, 1.0])
    return ext[:3, :4], center, view_dir, sensor_id, trans_g


def load_camera(
    calib_fname: str, img_name: str, resize_factor: int = 1, rt: int = 0
) -> Tuple[Dict, np.ndarray]:
    """Full camera dict for one view (reference camera.py:173-190)."""
    root = ET.parse(calib_fname).getroot().find("chunk")
    extrinsics, center, view_dir, sensor_id, trans_g = extract_extrinsics(
        root.find("cameras"), root.find("components"), img_name, rot=rt
    )
    radial, intrinsics, img_size = extract_intrinsics(
        root.find("sensors"), sensor_id, resize_factor, rot=rt
    )
    return (
        {
            "intrinsics": intrinsics,
            "extrinsics": extrinsics,
            "radial_distortion": radial,
            "camera_center": center,
            "view_direction": view_dir,
            "image_size": img_size,
            "name": img_name,
        },
        trans_g,
    )


def perspective_project(
    points: np.ndarray,
    intrinsics: np.ndarray,
    extrinsics: np.ndarray,
    radial_distortion: np.ndarray,
    eps: float = 1e-7,
) -> np.ndarray:
    """Project world points with radial distortion (camera.py:256-287)."""
    ones = np.ones((points.shape[0], 1))
    hom = np.concatenate([points, ones], axis=-1)
    img = (extrinsics @ hom.T).T
    z = img[:, 2].copy()
    z[np.abs(z) < eps] = 1.0
    img[:, 0] /= z
    img[:, 1] /= z
    k1, k2 = radial_distortion[0], radial_distortion[1]
    r2 = img[:, 0] ** 2 + img[:, 1] ** 2
    factor = 1 + k1 * r2 + k2 * r2**2
    img[:, 0] *= factor
    img[:, 1] *= factor
    img[:, 2] = 1.0
    return (intrinsics @ img.T).T


def batch_perspective_project(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    radial_distortion: torch.Tensor,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Batched distorted projection -> (B, N, 2) (camera.py:289-322), on
    the tensors' device: (B, N, 3) points with (B, 3, 4) extrinsics,
    (B, 3, 3) intrinsics, (B, 2) distortion."""
    cam = torch.einsum("bij,bnj->bni", extrinsics[:, :, :3], points) + extrinsics[:, None, :, 3]
    z = cam[..., 2]
    z = torch.where(torch.abs(z) < eps, torch.ones_like(z), z)
    x, y = cam[..., 0] / z, cam[..., 1] / z
    k1 = radial_distortion[:, 0:1]
    k2 = radial_distortion[:, 1:2]
    r2 = x * x + y * y
    f = 1.0 + k1 * r2 + k2 * r2 * r2
    ndc = torch.stack([x * f, y * f, torch.ones_like(z)], dim=-1)
    img = torch.einsum("bij,bnj->bni", intrinsics, ndc)
    return img[..., :2]


def scale_image(image: np.ndarray, scale_factor: float, camera=None):
    """Rescale an (H, W, C) image and (optionally) its intrinsics
    (camera.py:246-254).

    Integer 1/k factors (the only ones the pipeline uses, down_ratio 8/2/1)
    take exact integer-stride area averaging. Other factors resample each
    channel as the JAX package does through PIL's ``Image.resize(...,
    BILINEAR)`` on a mode-"F" plane (``bilinear_resize_plane``, in NumPy:
    the machines with the card have no PIL), to an output of round(H *
    factor) x round(W * factor) float32 values.
    """
    inv = 1.0 / scale_factor
    k = int(round(inv))
    h, w = image.shape[:2]
    if abs(inv - k) > 1e-6:
        h2 = max(int(round(h * scale_factor)), 1)
        w2 = max(int(round(w * scale_factor)), 1)
        img = np.stack(
            [bilinear_resize_plane(np.asarray(image[..., c], np.float32), h2, w2) for c in range(image.shape[2])],
            axis=-1,
        )
    else:
        hc, wc = (h // k) * k, (w // k) * k
        img = image[:hc, :wc].reshape(h // k, k, w // k, k, -1).mean(axis=(1, 3))
    if camera is None:
        return img
    camera = dict(camera)
    scale_mat = np.diag([scale_factor, scale_factor, 1.0])
    camera["intrinsics"] = scale_mat @ camera["intrinsics"]
    return img, camera


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` for the bilinear (triangle) filter
    (Resample.c): per output sample its first input sample, its tap count
    and its float64 weights, the support scaled by max(in/out, 1) and the
    weights normalised to sum 1 -> (first (out,), taps (out,), weights
    (out, ksize))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale  # PIL scales the filter's argument by the reciprocal
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = np.array([max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)])
        ww = 0.0
        for v in k:  # in tap order, as PIL sums them
            ww += v
        if ww != 0.0:
            k = k / ww
        first[xx], taps[xx] = xmin, xmax
        weights[xx, :xmax] = k
    return first, taps, weights


def _resample_axis(plane: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 32-bit float resampling along ``axis``: each output
    sample sums input x weight in float64, in tap order, and is stored as
    float32."""
    x = np.moveaxis(plane, axis, -1)
    first, taps, weights = _bilinear_coeffs(x.shape[-1], out_size)
    acc = np.zeros(x.shape[:-1] + (out_size,), np.float64)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, x.shape[-1] - 1)
        term = x[..., idx].astype(np.float64) * weights[:, j]
        acc = np.where(j < taps, acc + term, acc)
    return np.moveaxis(acc.astype(np.float32), -1, axis)


def bilinear_resize_plane(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """An (H, W) float32 plane resized to (height, width) as PIL's
    ``Image.fromarray(plane, mode="F").resize((width, height), BILINEAR)``
    does: the horizontal pass first, then the vertical, each skipped when
    its size does not change."""
    out = np.asarray(plane, np.float32)
    if width != out.shape[1]:
        out = _resample_axis(out, width, 1)
    if height != out.shape[0]:
        out = _resample_axis(out, height, 0)
    return out


def rotate_image_cam(image: np.ndarray, camera=None, angle: int = 90):
    """Rotate an image and adjust the camera intrinsics (camera.py:207-241)."""
    img = rotate_image(image, angle)
    if camera is None:
        return img
    camera = dict(camera)
    h = camera["image_size"][1]
    rt = np.array([[0, 1, 0], [-1, 0, float(h)], [0, 0, 1]])
    fx, fy = camera["intrinsics"][0, 0], camera["intrinsics"][1, 1]
    k = rt @ camera["intrinsics"]
    k[0, 0], k[1, 1] = fy, fx
    k[0, 1] = k[1, 0] = 0.0
    camera["intrinsics"] = k
    camera["image_size"] = camera["image_size"][::-1]
    return img, camera


def rotate_image(image: np.ndarray, angle_deg: int) -> np.ndarray:
    """Rotate an (H, W, C) image by a multiple of 90 degrees (resize=True).

    The reference uses skimage.transform.rotate (camera.py:203-205); all
    call sites pass +/-90, for which an exact rot90 is equivalent and far
    cheaper. angle follows skimage's counter-clockwise convention.
    """
    quarter = (angle_deg // 90) % 4
    if angle_deg % 90 != 0:
        raise ValueError("only multiples of 90 degrees are supported")
    return np.rot90(image, k=quarter, axes=(0, 1)).copy()
