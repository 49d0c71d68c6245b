"""refid_tpu_torch's core/timer.py and utils/ against refid_tpu's: flow IO and
quantization (files written by one package read by the other), the timers'
stats, the face helper's geometry against the cv2-backed JAX helper, the
dlib gate, and download_util against fakes, as tests/test_utils_tail.py."""

import io
import os
import time

import cv2
import numpy as np
import pytest
import torch

from refid_tpu.core import timer as jax_timer
from refid_tpu.utils import download_util as jax_download
from refid_tpu.utils import face_util as jax_face
from refid_tpu.utils import flow_util as jax_flow
from refid_tpu_torch.core import timer
from refid_tpu_torch.utils import download_util, face_util, flow_util

torch.set_num_threads(1)

# cv2 interpolates at 1/32-pixel positions with fixed-point weights and the
# port in float64 (face_util.py's docstring): uint8 results on smooth images
# agree within 1 level, composites (then truncated to uint8) within 2
WARP_LEVELS, PASTE_LEVELS = 1, 2


def _smooth(h, w, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    phase = np.random.RandomState(seed).rand(3) * 3
    return np.stack([128 + 100 * np.sin(xx / 9.0 + p) * np.cos(yy / 7.0 - p) for p in phase],
                    -1).astype(np.uint8)


# ---- flow_util ---------------------------------------------------------

def test_flo_files_cross_read(tmp_path):
    flow = np.random.RandomState(0).randn(12, 17, 2).astype(np.float32) * 3
    flow_util.flowwrite(flow, tmp_path / "a.flo")
    jax_flow.flowwrite(flow, tmp_path / "b.flo")
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    np.testing.assert_array_equal(flow_util.flowread(tmp_path / "b.flo"), flow)
    (tmp_path / "bad.flo").write_bytes(b"XXXX" + b"\0" * 16)
    with pytest.raises(IOError):
        flow_util.flowread(tmp_path / "bad.flo")


def test_quantized_flow_equals_jax(tmp_path):
    rng = np.random.RandomState(1)
    h, w = 16, 20
    flow = rng.uniform(-0.03, 0.03, (h, w, 2)).astype(np.float32) * [w, h]
    for got, want in zip(flow_util.quantize_flow(flow), jax_flow.quantize_flow(flow)):
        np.testing.assert_array_equal(got, want)
    dx, dy = jax_flow.quantize_flow(flow)
    np.testing.assert_array_equal(flow_util.dequantize_flow(dx, dy),
                                  jax_flow.dequantize_flow(dx, dy))
    for axis in (0, 1):         # the port's PNG read by cv2 through the JAX reader, and back
        flow_util.flowwrite(flow, str(tmp_path / f"p{axis}.png"), quantize=True, concat_axis=axis)
        jax_flow.flowwrite(flow, str(tmp_path / f"j{axis}.png"), quantize=True, concat_axis=axis)
        want = jax_flow.flowread(str(tmp_path / f"j{axis}.png"), quantize=True, concat_axis=axis)
        np.testing.assert_array_equal(
            jax_flow.flowread(str(tmp_path / f"p{axis}.png"), quantize=True, concat_axis=axis),
            want)
        np.testing.assert_array_equal(
            flow_util.flowread(str(tmp_path / f"j{axis}.png"), quantize=True,
                               concat_axis=axis), want)
    for bad in ((np.zeros(3), 0, 1, 1), (np.zeros(3), 1, 0, 8)):
        with pytest.raises(ValueError):
            flow_util.quantize(*bad)
        with pytest.raises(ValueError):
            flow_util.dequantize(*bad)


# ---- core/timer --------------------------------------------------------

def test_timer_stats_match_jax(capsys):
    for mod, name in ((timer, "port_block"), (jax_timer, "jax_block")):
        for _ in range(4):
            with mod.Timer(name, print_every=2):
                time.sleep(0.002)
        with mod.DeviceTimer(name + "_device"):
            torch.ones(4).sum()
    got, want = timer.timer_stats(), jax_timer.timer_stats()
    for suffix in ("block", "block_device"):
        g, w = got[f"port_{suffix}"], want[f"jax_{suffix}"]
        assert g.keys() == w.keys() and g["count"] == w["count"]
        assert g["total_s"] > 0 and g["avg_ms"] == pytest.approx(1000 * g["total_s"] / g["count"])
    assert got["port_block"]["avg_ms"] >= 2.0
    printed = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[port_block] avg") for line in printed) == 2
    timer.print_timer_stats()
    assert "[port_block] total" in capsys.readouterr().out


# ---- face_util ---------------------------------------------------------

def test_estimate_similarity_equals_jax():
    rng = np.random.RandomState(2)
    src = rng.rand(5, 2) * 100
    dst = src @ np.array([[1.2, -0.3], [0.4, 0.9]]) + [4.0, -2.5] + rng.randn(5, 2)
    np.testing.assert_allclose(face_util.estimate_similarity(src, dst),
                               jax_face.estimate_similarity(src, dst), atol=1e-12)


def test_cv2_replacements_match_cv2():
    img = _smooth(96, 112)
    th = 0.3
    M = np.array([[1.1 * np.cos(th), -1.1 * np.sin(th), 5.3],
                  [1.1 * np.sin(th), 1.1 * np.cos(th), -7.2]])
    diff = np.abs(face_util.warp_affine(img, M, (80, 70)).astype(int)
                  - cv2.warpAffine(img, M, (80, 70)))
    assert diff.max() <= WARP_LEVELS
    mask = np.ones((64, 64, 3), np.float32)
    np.testing.assert_allclose(face_util.warp_affine(mask, M, (80, 70)),
                               cv2.warpAffine(mask, M, (80, 70)), atol=1e-4)
    for size in ((224, 192), (336, 288)):
        assert np.abs(face_util.resize_bilinear(img, size).astype(int)
                      - cv2.resize(img, size)).max() <= WARP_LEVELS
    rand = np.random.RandomState(3).rand(40, 50, 3).astype(np.float32)
    for k in (2, 3, 4, 6):
        np.testing.assert_array_equal(face_util.erode(rand, k),
                                      cv2.erode(rand, np.ones((k, k), np.uint8)))
    for k in (3, 5, 7, 9, 13, 21):
        np.testing.assert_allclose(face_util.gaussian_blur(rand, k),
                                   cv2.GaussianBlur(rand, (k, k), 0), atol=1e-6)


@pytest.mark.parametrize("upscale", [1, 2])
def test_face_helper_matches_jax_helper(tmp_path, upscale):
    """Crop and paste of one face against the JAX helper (cv2): the crop
    within WARP_LEVELS, the composite within PASTE_LEVELS; and the identity
    crop and paste of tests/test_utils_tail.py exactly."""
    img = _smooth(160, 150, seed=upscale)
    results = []
    for mod in (jax_face, face_util):
        helper = mod.FaceRestorationHelper(upscale_factor=upscale, face_size=128)
        helper.input_img = img
        helper.all_landmarks_5.append(helper.face_template * 0.9 + [6.0, 3.0])
        helper.warp_crop_faces(save_inverse_affine_path=str(tmp_path / f"{mod.__name__}.npy"))
        crop = helper.cropped_faces[0]
        helper.add_restored_face(np.ascontiguousarray(255 - crop[..., ::-1]))
        results.append((crop, helper.paste_faces_to_input_image(), helper))
    (want_crop, want_out, jhelper), (crop, out, helper) = results
    assert np.abs(crop.astype(int) - want_crop).max() <= WARP_LEVELS
    assert np.abs(out.astype(int) - want_out).max() <= PASTE_LEVELS
    np.testing.assert_allclose(helper.inverse_affine_matrices[0],
                               jhelper.inverse_affine_matrices[0], atol=1e-12)

    identity = face_util.FaceRestorationHelper(upscale_factor=1, face_size=128)
    identity.input_img = img
    identity.all_landmarks_5.append(identity.face_template.copy())
    identity.warp_crop_faces(save_cropped_path=str(tmp_path / "c.png"))
    np.testing.assert_array_equal(identity.cropped_faces[0], img[:128, :128])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c_00.png"))[..., ::-1],
                                  img[:128, :128])
    identity.add_restored_face(np.ascontiguousarray(img[:128, :128, ::-1]))
    pasted = identity.paste_faces_to_input_image(str(tmp_path / "out.jpg"))
    np.testing.assert_array_equal(pasted[8:120, 8:120], img[8:120, 8:120, ::-1])
    assert os.path.exists(tmp_path / "out.png")
    identity.clean_all()
    assert not identity.restored_faces and not identity.affine_matrices


def test_face_helper_reads_png_and_gates_dlib(tmp_path):
    img = _smooth(20, 30)
    cv2.imwrite(str(tmp_path / "in.png"), img[..., ::-1])
    helper = face_util.FaceRestorationHelper(upscale_factor=2)
    helper.read_input_image(tmp_path / "in.png")
    np.testing.assert_array_equal(helper.input_img, img)
    with pytest.raises(ImportError, match="dlib"):
        helper.init_dlib("a", "b", "c")
    with pytest.raises(RuntimeError, match="init_dlib"):
        helper.detect_faces("x.png")


# ---- download_util -----------------------------------------------------

class _FakeResponse:
    def __init__(self, data, cookies=None):
        self._data = data
        self.cookies = cookies or {}
        self.headers = {}

    def iter_content(self, chunk_size):
        buf = io.BytesIO(self._data)
        while chunk := buf.read(chunk_size):
            yield chunk


class _FakeSession:
    """``requests.Session`` serving a drive interstitial, then the file."""

    def __init__(self, data):
        self.data, self.calls = data, []

    def get(self, url, params=None, stream=False, headers=None):
        self.calls.append((url, dict(params), headers))
        if headers:
            resp = _FakeResponse(b"")
            resp.headers["Content-Range"] = f"bytes 0-2/{len(self.data)}"
            return resp
        if "confirm" not in params:
            return _FakeResponse(b"", {"download_warning_x": "tok"})
        return _FakeResponse(self.data)


def test_download_pieces_equal_jax(tmp_path, monkeypatch):
    for mod in (download_util, jax_download):
        assert mod.get_confirm_token(_FakeResponse(b"", {"x": "1"})) is None
        assert mod.get_confirm_token(_FakeResponse(b"", {"download_warning_ab": "t"})) == "t"
    for size in (0, 1536, 3 * 1024 ** 3, 5e30):
        assert download_util.sizeof_fmt(size) == jax_download.sizeof_fmt(size)
    data = bytes(range(256)) * 500
    for mod in (download_util, jax_download):
        dest = tmp_path / f"{mod.__name__}.bin"
        mod.save_response_content(_FakeResponse(data), dest, file_size=len(data),
                                  chunk_size=4096)
        assert dest.read_bytes() == data

    import requests
    session = _FakeSession(data)
    monkeypatch.setattr(requests, "Session", lambda: session)
    download_util.download_file_from_google_drive("abc", tmp_path / "drive.bin")
    assert (tmp_path / "drive.bin").read_bytes() == data
    assert [c[1] for c in session.calls] == [{"id": "abc"}, {"id": "abc", "confirm": "tok"},
                                             {"id": "abc", "confirm": "tok"}]
