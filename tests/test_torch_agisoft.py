"""The Agisoft calibration loader of ``topo4d_tpu_torch/core/agisoft.py``
against the JAX package's, exact in float64.

The four ``test_agisoft_*`` cases of ``tests/test_asset_ingestion.py`` on
its XML (copied here): a multi-sensor chunk at resize 8, the portrait swap
under ``rot``, the OpenGL -> COLMAP flips, a chunk without
``<components>``; each asserted as there and held to JAX's dicts with
``assert_array_equal``. Then the other functions of the module: the
distortion conversion, the rotations, the projections (the batched one on
tensors, rtol 1e-6 in float32) and ``scale_image``: the integer path, and
other factors against JAX's PIL resampling bit for bit.
"""

import textwrap

import numpy as np
import pytest
import torch

from topo4d_tpu.core import agisoft as J

from topo4d_tpu_torch.core import agisoft as P

MULTI_SENSOR_XML = textwrap.dedent("""\
    <document version="1.5.0">
      <chunk label="head" enabled="true">
        <sensors next_id="2">
          <sensor id="0" label="landscape" type="frame">
            <resolution width="4096" height="3000"/>
            <property name="pixel_width" value="0.0034"/>
            <property name="pixel_height" value="0.0034"/>
            <calibration type="frame" class="adjusted">
              <resolution width="4096" height="3000"/>
              <f>8000.5</f>
              <cx>12.25</cx>
              <cy>-7.5</cy>
              <k1>0.02</k1>
              <k2>-0.001</k2>
            </calibration>
          </sensor>
          <sensor id="1" label="portrait" type="frame">
            <resolution width="3000" height="4096"/>
            <calibration type="frame" class="adjusted">
              <f>7800.0</f>
            </calibration>
          </sensor>
        </sensors>
        <components next_id="1" active_id="0">
          <component id="0" label="co">
            <transform>
              <rotation>0 -1 0 1 0 0 0 0 1</rotation>
              <translation>0.1 0.2 0.3</translation>
            </transform>
          </component>
        </components>
        <cameras next_id="2">
          <camera id="0" sensor_id="0" component_id="0" label="camA">
            <transform>1 0 0 0.5  0 1 0 0.25  0 0 1 2.0  0 0 0 1</transform>
          </camera>
          <camera id="1" sensor_id="1" component_id="0" label="camB">
            <transform>0 0 1 1.0  0 1 0 0.0  -1 0 0 0.0  0 0 0 1</transform>
          </camera>
        </cameras>
      </chunk>
    </document>
""")

# same chunk without a <components> node at all (Metashape exports from
# single-component projects can omit it; trans_g must default to identity)
NO_COMPONENT_XML = MULTI_SENSOR_XML.replace(
    MULTI_SENSOR_XML[
        MULTI_SENSOR_XML.index("<components") :
        MULTI_SENSOR_XML.index("</components>") + len("</components>")
    ],
    "",
)


@pytest.fixture()
def xml_paths(tmp_path):
    p1 = tmp_path / "cameras.xml"
    p1.write_text(MULTI_SENSOR_XML)
    p2 = tmp_path / "cameras_nocomp.xml"
    p2.write_text(NO_COMPONENT_XML)
    return str(p1), str(p2)


def _both(path, name, **kw):
    """The port's (camera dict, trans_g) after checking it equals JAX's."""
    cam, g = P.load_camera(path, name, **kw)
    jcam, jg = J.load_camera(path, name, **kw)
    assert sorted(cam) == sorted(jcam)
    for k in jcam:
        if k == "name":
            assert cam[k] == jcam[k]
        else:
            assert np.asarray(cam[k]).dtype == np.asarray(jcam[k]).dtype, k
            np.testing.assert_array_equal(cam[k], jcam[k], err_msg=k)
    np.testing.assert_array_equal(g, jg)
    return cam, g


def test_agisoft_multi_sensor_intrinsics(xml_paths):
    cam, trans_g = _both(xml_paths[0], "camA", resize_factor=8, rt=0)
    k = cam["intrinsics"]
    np.testing.assert_allclose(k[0, 0], 8000.5 / 8)
    np.testing.assert_allclose(k[0, 2], (2048 + 12.25) / 8)
    np.testing.assert_allclose(k[1, 2], (1500 - 7.5) / 8)
    np.testing.assert_array_equal(cam["image_size"], [375, 512])
    expect_g = np.eye(4)
    expect_g[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    expect_g[:3, 3] = [0.1, 0.2, 0.3]
    np.testing.assert_allclose(trans_g, expect_g)


@pytest.mark.parametrize("rt", [1, -1])
def test_agisoft_portrait_sensor_rotation_swap(xml_paths, rt):
    cam, _ = _both(xml_paths[0], "camB", resize_factor=1, rt=rt)
    k = cam["intrinsics"]
    w, h = 3000, 4096
    np.testing.assert_allclose(k[0, 0], 7800.0)
    np.testing.assert_allclose(k[0, 2], h / 2.0)
    np.testing.assert_allclose(k[1, 2], w - w / 2.0)
    np.testing.assert_array_equal(cam["image_size"], [w, h])
    # the landscape sensor under the same swap, at the working ratio
    _both(xml_paths[0], "camA", resize_factor=8, rt=rt)


def test_agisoft_extrinsics_opengl_colmap_flip(xml_paths):
    cam, _ = _both(xml_paths[0], "camA", resize_factor=1, rt=0)
    expect = np.array([[1, 0, 0, -0.5], [0, 1, 0, -0.25], [0, 0, 1, -2.0]], float)
    np.testing.assert_allclose(cam["extrinsics"], expect, atol=1e-12)
    np.testing.assert_allclose(cam["camera_center"], [0.5, 0.25, 2.0])


def test_agisoft_component_less_chunk(xml_paths):
    cam_a, trans_g = _both(xml_paths[1], "camA", resize_factor=8)
    np.testing.assert_allclose(trans_g, np.eye(4))
    cam_ref, _ = _both(xml_paths[0], "camA", resize_factor=8)
    np.testing.assert_allclose(cam_a["extrinsics"], cam_ref["extrinsics"])
    np.testing.assert_allclose(cam_a["intrinsics"], cam_ref["intrinsics"])


def test_agisoft_unknown_names_raise(xml_paths):
    for mod in (P, J):
        with pytest.raises(ValueError, match="camera nope not found"):
            mod.load_camera(xml_paths[0], "nope")


@pytest.mark.parametrize("args", [(0.02, -0.001, 8000.5 * 0.0034, 1000.0, 1000.0, 512, 375), (0.0, 0.0, 30.0, 950.0, 960.0, 375, 512)])
def test_convert_distortion_parms(args):
    assert P.convert_distortion_parms(*args) == J.convert_distortion_parms(*args)


@pytest.mark.parametrize("angle", [90, -90, 180, 270, 0])
def test_rotate_image(angle):
    img = np.random.default_rng(angle % 7).uniform(size=(5, 7, 3)).astype(np.float32)
    got = P.rotate_image(img, angle)
    np.testing.assert_array_equal(got, J.rotate_image(img, angle))
    with pytest.raises(ValueError, match="multiples of 90"):
        P.rotate_image(img, 45)


def test_rotate_image_cam(xml_paths):
    cam, _ = P.load_camera(xml_paths[0], "camA", resize_factor=8)
    img = np.random.default_rng(2).uniform(size=(375, 512, 3)).astype(np.float32)
    got_img, got_cam = P.rotate_image_cam(img, cam, 90)
    want_img, want_cam = J.rotate_image_cam(img, cam, 90)
    np.testing.assert_array_equal(got_img, want_img)
    for k in ("intrinsics", "image_size"):
        np.testing.assert_array_equal(got_cam[k], want_cam[k])


def test_perspective_projections(xml_paths):
    cams = [P.load_camera(xml_paths[0], n, resize_factor=8)[0] for n in ("camA", "camB")]
    pts = np.random.default_rng(3).normal(0.0, 0.3, (2, 50, 3)) + np.array([0.0, 0.0, 4.0])
    for cam, p in zip(cams, pts):
        args = (p, cam["intrinsics"], cam["extrinsics"], np.array([0.01, -0.002]))
        np.testing.assert_array_equal(P.perspective_project(*args), J.perspective_project(*args))
    ks = np.stack([c["intrinsics"] for c in cams]).astype(np.float32)
    es = np.stack([c["extrinsics"] for c in cams]).astype(np.float32)
    dist = np.array([[0.01, -0.002], [0.0, 0.003]], np.float32)
    want = np.asarray(J.batch_perspective_project(pts.astype(np.float32), ks, es, dist))
    t = torch.as_tensor
    got = P.batch_perspective_project(t(pts.astype(np.float32)), t(ks), t(es), t(dist)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_scale_image_integer_path_and_refusal(xml_paths):
    cam, _ = P.load_camera(xml_paths[0], "camA", resize_factor=8)
    img = np.random.default_rng(4).uniform(size=(37, 50, 3))
    for factor in (0.5, 0.25, 1.0):
        got_img, got_cam = P.scale_image(img, factor, cam)
        want_img, want_cam = J.scale_image(img, factor, cam)
        np.testing.assert_array_equal(got_img, want_img)
        np.testing.assert_array_equal(got_cam["intrinsics"], want_cam["intrinsics"])
    # a factor other than 1/k resamples as JAX's PIL path does (no longer refused)
    np.testing.assert_array_equal(P.scale_image(img, 0.3), J.scale_image(img, 0.3))


@pytest.mark.parametrize("factor", [0.3, 0.75, 2 / 3, 1.5])
def test_scale_image_bilinear_matches_jax_pil(xml_paths, factor):
    """Factors other than 1/k: the port's NumPy resampling against JAX's
    PIL ``BILINEAR`` on mode-"F" planes, RGB float32, bit for bit; the
    intrinsics scaled alike."""
    cam, _ = P.load_camera(xml_paths[0], "camA", resize_factor=8)
    img = np.random.default_rng(5).uniform(-0.5, 1.5, size=(61, 47, 3)).astype(np.float32)
    got_img, got_cam = P.scale_image(img, factor, cam)
    want_img, want_cam = J.scale_image(img, factor, cam)
    assert got_img.dtype == want_img.dtype == np.float32
    assert got_img.shape == want_img.shape == (round(61 * factor), round(47 * factor), 3)
    np.testing.assert_array_equal(got_img.view(np.int32), want_img.view(np.int32))
    np.testing.assert_array_equal(got_cam["intrinsics"], want_cam["intrinsics"])
