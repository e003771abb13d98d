"""The port's data layer (``raft_stereo_tpu_torch.data``) against PIL, cv2
and the JAX package's readers and datasets.

* ``png.py`` decodes files written by PIL and by cv2 bitwise equal to what
  those libraries read back, at every supported depth and channel count;
  seeded arrays written with each of the five row filters decode exactly;
  PIL and cv2 read ``write_png``'s files back bitwise; unsupported and
  damaged PNGs raise, naming the file;
* each port reader returns the JAX reader's arrays on the same file;
* each dataset class's ``sample(i)`` is bitwise equal to the JAX class's
  on the same synthetic tree; with ``aug_params`` (a crop size) the
  augmented sample is the JAX dataset's for the same generator.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.data import frame_utils as jfu
from raft_stereo_tpu_torch.data import datasets as tds
from raft_stereo_tpu_torch.data import frame_utils as tfu
from raft_stereo_tpu_torch.data import png

import torch_parity as tp
from torch_parity import (jax_readers_without_native,  # noqa: F401
                          torch_one_thread)

SHAPE = (37, 53)


def _array(seed, channels, dtype, textured):
    """Seeded samples: uniform noise, or a smooth field (which PIL and
    libpng filter with Sub/Up/Paeth rather than None)."""
    rng = np.random.default_rng(seed)
    top = 256 if dtype == np.uint8 else 65536
    shape = SHAPE + ((channels,) if channels > 1 else ())
    if not textured:
        return rng.integers(0, top, shape, dtype=dtype)
    small = rng.uniform(0, top - 1, (6, 8, channels)).astype(np.float32)
    big = cv2.resize(small, SHAPE[::-1], interpolation=cv2.INTER_LINEAR)
    return big.reshape(shape).astype(dtype)


def _filtered_png(arr, filters):
    """A PNG of ``arr`` whose row ``y`` uses filter ``filters[y % len]``
    (the encoder half of the PNG spec's filter algorithms)."""
    a = arr if arr.ndim == 3 else arr[..., None]
    h, w, c = a.shape
    bpp = c * a.itemsize
    raw = a.astype(">u2" if a.itemsize == 2 else np.uint8).view(
        np.uint8).reshape(h, w * bpp).astype(np.int32)
    out = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            pa, pb, pc = np.abs(up - ul), np.abs(left - ul), \
                np.abs(left + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * a.itemsize,
                       {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    return _png_bytes([(b"IHDR", ihdr),
                       (b"IDAT", zlib.compress(b"".join(out))),
                       (b"IEND", b"")])


def _png_bytes(chunks):
    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))
    return png.SIGNATURE + b"".join(chunk(t, b) for t, b in chunks)


# the modes PIL writes (Image.fromarray infers each from the array)
PIL_MODES = [("L", 1, np.uint8), ("LA", 2, np.uint8), ("RGB", 3, np.uint8),
             ("RGBA", 4, np.uint8), ("I;16", 1, np.uint16)]


@pytest.mark.parametrize("textured", [False, True], ids=["noise", "smooth"])
@pytest.mark.parametrize("mode,channels,dtype", PIL_MODES,
                         ids=[m[0] for m in PIL_MODES])
def test_png_decodes_pil_files(tmp_path, mode, channels, dtype, textured):
    arr = _array(channels, channels, dtype, textured)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    want = np.asarray(Image.open(path))
    assert Image.open(path).mode == mode
    assert np.array_equal(png.read_png(path), want)
    got = tfu.read_image(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, jfu.read_image(path))


@pytest.mark.parametrize("textured", [False, True], ids=["noise", "smooth"])
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_png_decodes_cv2_files(tmp_path, dtype, channels, textured):
    arr = _array(10 + channels, channels, dtype, textured)  # BGR(A) order
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, arr)
    unchanged = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_UNCHANGED)
    color = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    assert np.array_equal(tfu._read_png_cv2(path), unchanged)
    assert np.array_equal(tfu._read_png_rgb(path), color[..., ::-1])
    if dtype == np.uint16 and channels == 1:
        assert np.array_equal(tfu.read_disp_kitti(path)[0],
                              jfu.read_disp_kitti(path)[0])


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_png_every_filter(tmp_path, dtype, channels):
    """Rows cycle through filters 0-4, and images of one filter or a mix
    of None/Sub/Up rows (png.py undoes those a row at a time, the rest
    on anti-diagonals): png.py gives the array back, PIL and cv2 agree
    with it."""
    arr = _array(20 + channels, channels, dtype, True)
    for filters in ([0, 1, 2, 3, 4], [4], [3, 1], [0, 1, 2], [1], [2],
                    [3]):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        with open(path, "wb") as f:
            f.write(_filtered_png(arr, filters))
        assert np.array_equal(png.read_png(path), arr)
        assert np.array_equal(tfu.read_image(path), np.asarray(
            Image.open(path)))
        unchanged = cv2.imread(path, cv2.IMREAD_ANYDEPTH |
                               cv2.IMREAD_UNCHANGED)
        assert np.array_equal(tfu._read_png_cv2(path), unchanged)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=["u8", "u16"])
def test_write_png_reads_back_in_pil_and_cv2(tmp_path, dtype, channels,
                                             filter_type):
    arr = _array(30 + channels, channels, dtype, filter_type % 2 == 1)
    path = str(tmp_path / "x.png")
    png.write_png(path, arr, filter_type)
    with open(path, "rb") as f:  # every row carries the filter asked for
        assert f.read() == _filtered_png(arr, [filter_type])
    assert np.array_equal(png.read_png(path), arr)
    pil = np.asarray(Image.open(path))
    assert np.array_equal(pil, tfu.read_image(path))
    if dtype == np.uint8 or channels == 1:
        assert np.array_equal(pil, arr)
    unchanged = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_UNCHANGED)
    assert np.array_equal(unchanged, tfu._read_png_cv2(path))


def _unsupported(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (8, 9, 3), dtype=np.uint8)
    good = png.encode_png(rgb)
    ihdr = bytearray(good[16:29])
    cases = {}
    Image.fromarray(rgb).convert("P").save(tmp_path / "palette.png")
    Image.fromarray(rgb[..., 0] > 100).save(tmp_path / "onebit.png")
    Image.fromarray(rgb).save(tmp_path / "trns.png", transparency=(1, 2, 3))
    for name in ("palette", "onebit", "trns"):
        cases[name] = (tmp_path / f"{name}.png").read_bytes()
    ihdr[12] = 1  # interlace method: Adam7
    cases["interlaced"] = _png_bytes([(b"IHDR", bytes(ihdr)),
                                      (b"IDAT", zlib.compress(b"")),
                                      (b"IEND", b"")])
    bad = bytearray(good)
    bad[40] ^= 0xFF  # inside IDAT: the CRC no longer matches
    cases["bad_crc"] = bytes(bad)
    cases["truncated"] = good[:len(good) // 2]
    cases["not_png"] = b"GIF89a" + good[6:]
    Image.fromarray(rgb).save(tmp_path / "jpeg.jpg")
    cases["jpeg"] = (tmp_path / "jpeg.jpg").read_bytes()
    return cases


UNSUPPORTED = ["palette", "onebit", "trns", "interlaced", "bad_crc",
               "truncated", "not_png", "jpeg"]


@pytest.mark.parametrize("case", UNSUPPORTED)
def test_png_raises_on_unsupported_files(tmp_path, case):
    path = tmp_path / f"{case}.png"
    path.write_bytes(_unsupported(tmp_path)[case])
    with pytest.raises(ValueError, match=case):
        png.read_png(str(path))
    with pytest.raises(ValueError, match=case):
        tfu.read_image(str(path))
    with pytest.raises(ValueError, match="float32"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="filter 5"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.uint8), 5)


# -------------------------------------------------------------- readers

def _reader_files(tmp_path):
    rng = np.random.default_rng(7)
    d = tmp_path
    disp = rng.uniform(0, 90, (11, 13)).astype(np.float32)
    disp[0, 0] = np.inf
    jfu.write_pfm(str(d / "one.pfm"), disp)
    tfu.write_pfm(str(d / "one_port.pfm"), disp)
    three = rng.normal(size=(5, 6, 3)).astype(">f4")
    with open(d / "three.pfm", "wb") as f:  # big-endian, 3 channels
        f.write(b"PF\n6 5\n1.0\n" + np.flipud(three).tobytes())
    flow = rng.normal(size=(7, 9, 2)).astype(np.float32)
    jfu.write_flo(str(d / "f.flo"), flow)
    tfu.write_flo(str(d / "f_port.flo"), flow)
    jfu.write_flow_kitti(str(d / "flow.png"), flow * 30)
    tfu.write_flow_kitti(str(d / "flow_port.png"), flow * 30)
    cv2.imwrite(str(d / "kitti.png"), (rng.uniform(0, 60, (11, 13)) * 256
                                       ).astype(np.uint16))
    gt = d / "disp0GT.pfm"
    jfu.write_pfm(str(gt), disp)
    tp.pil_png(d / "mask0nocc.png", (rng.uniform(size=(11, 13)) > 0.5
                                     ).astype(np.uint8) * 255)
    jfu.write_pfm(str(d / "disp0.pfm"), disp * 20)
    sintel = d / "disparities" / "s" / "frame_0001.png"
    tp.pil_png(sintel, rng.integers(0, 255, (11, 13, 3), dtype=np.uint8))
    tp.pil_png(d / "occlusions" / "s" / "frame_0001.png",
               (rng.uniform(size=(11, 13)) > 0.7).astype(np.uint8) * 255)
    tp.cv2_png16(d / "ft" / "0.left.depth.png",
                 rng.integers(0, 3000, (11, 13), dtype=np.uint16))
    (d / "ft" / "_camera_settings.json").write_text(json.dumps(
        {"camera_settings": [{"intrinsic_settings": {"fx": 768.16}}]}))
    depth = rng.uniform(0, 40, (11, 13)).astype(np.float32)
    depth[1, 1] = 0.0
    np.save(d / "depth.npy", depth)
    tp.pil_png(d / "img.png", rng.integers(0, 255, (11, 13, 3),
                                           dtype=np.uint8))
    return d


READERS = [
    ("read_pfm", "one.pfm"), ("read_pfm", "one_port.pfm"),
    ("read_pfm", "three.pfm"), ("read_flo", "f.flo"),
    ("read_flo", "f_port.flo"), ("read_flow_kitti", "flow.png"),
    ("read_flow_kitti", "flow_port.png"), ("read_disp_kitti", "kitti.png"),
    ("read_disp_eth3d", "one.pfm"), ("read_disp_pfm", "one.pfm"),
    ("read_disp_pfm", "three.pfm"),
    ("read_disp_middlebury", "disp0GT.pfm"),
    ("read_disp_middlebury", "disp0.pfm"),
    ("read_disp_sintel", "disparities/s/frame_0001.png"),
    ("read_disp_falling_things", "ft/0.left.depth.png"),
    ("read_disp_tartanair", "depth.npy"), ("read_image", "img.png"),
    ("read_gen", "img.png"), ("read_gen", "one.pfm"),
    ("read_gen", "three.pfm"), ("read_gen", "f.flo"),
    ("read_gen", "depth.npy"),
]


@pytest.mark.parametrize("reader,name", READERS,
                         ids=[f"{r}-{n}" for r, n in READERS])
def test_reader_equals_jax_reader(tmp_path, reader, name):
    path = str(_reader_files(tmp_path) / name)
    got = getattr(tfu, reader)(path)
    want = getattr(jfu, reader)(path)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
    assert tfu.DISPARITY_READERS.keys() == jfu.DISPARITY_READERS.keys()


# ------------------------------------------------------------- datasets

def _tree(tmp_path):
    ds = tmp_path / "datasets"
    rng = np.random.default_rng(11)
    tp.write_eval_tree(ds, rng)
    tp.write_things(ds, rng, n=2, split="TRAIN", dstype="frames_cleanpass")
    tp.write_middlebury(ds, rng, splits=("F", "H", "Q"))
    tp.write_middlebury_2014(ds, rng)
    tp.write_sintel(ds, rng)
    tp.write_falling_things(ds, rng)
    tp.write_tartanair(ds, rng)
    return ds


def _make(mod, name, ds):
    root = str(ds)
    return {
        "sceneflow_test": lambda: mod.SceneFlow(
            root=root, dstype="frames_finalpass", things_test=True),
        "sceneflow_train": lambda: mod.SceneFlow(root=root),
        "eth3d": lambda: mod.ETH3D(root=f"{root}/ETH3D"),
        "kitti": lambda: mod.KITTI(root=f"{root}/KITTI"),
        "kitti_split": lambda: mod.KITTI(root=f"{root}/KITTI",
                                         split="kitti"),
        "middlebury_F": lambda: mod.Middlebury(root=f"{root}/Middlebury"),
        "middlebury_H": lambda: mod.Middlebury(root=f"{root}/Middlebury",
                                               split="H"),
        "middlebury_Q": lambda: mod.Middlebury(root=f"{root}/Middlebury",
                                               split="Q"),
        "middlebury_2014": lambda: mod.Middlebury(
            root=f"{root}/Middlebury", split="2014"),
        "sintel": lambda: mod.SintelStereo(root=f"{root}/SintelStereo"),
        "falling_things": lambda: mod.FallingThings(
            root=f"{root}/FallingThings"),
        "tartanair": lambda: mod.TartanAir(root=root),
        "composed": lambda: (mod.ETH3D(root=f"{root}/ETH3D") * 2
                             + mod.KITTI(root=f"{root}/KITTI")),
    }[name]()


DATASETS = ["sceneflow_test", "sceneflow_train", "eth3d", "kitti",
            "kitti_split", "middlebury_F", "middlebury_H", "middlebury_Q",
            "middlebury_2014", "sintel", "falling_things", "tartanair",
            "composed"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("data_tree"))


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_sample_equals_jax(tree, name):
    got_ds, want_ds = _make(tds, name, tree), _make(jds, name, tree)
    assert len(got_ds) == len(want_ds) > 0
    assert got_ds.image_list == want_ds.image_list
    assert got_ds.disparity_list == want_ds.disparity_list
    for i in range(len(got_ds) + 1):  # the last index wraps around
        got, want = got_ds.sample(i), want_ds.sample(i)
        assert got.keys() == want.keys()
        for k in got:
            if k == "paths":
                assert got[k] == want[k]
                continue
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k], equal_nan=True), (name,
                                                                     i, k)


def test_aug_params_raise(tree):
    """``aug_params`` no longer raises (it did before the augmentor was
    ported): with a crop size the sample is the JAX dataset's augmented
    sample for the same generator (and, without one, for the index-keyed
    Philox default), images and valid bitwise, flow within 4e-5 of its
    largest magnitude (tests/test_torch_augment.py); without a crop size
    the frames are unaugmented."""
    aug = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4}
    for cls, root in ((tds.KITTI, f"{tree}/KITTI"),
                      (tds.SceneFlow, str(tree))):
        jcls = getattr(jds, cls.__name__)
        kw = {} if cls is tds.KITTI else dict(dstype="frames_finalpass",
                                                things_test=True)
        got_ds, want_ds = cls(aug, root=root, **kw), jcls(aug, root=root,
                                                          **kw)
        assert len(got_ds) == len(want_ds) > 0
        for i in range(len(got_ds)):
            for rng in ((np.random.default_rng(i), np.random.default_rng(i)),
                        (None, None)):
                got, want = got_ds.sample(i, rng[0]), want_ds.sample(i,
                                                                     rng[1])
                assert got["image1"].shape == (32, 48, 3)
                for k in ("image1", "image2", "valid"):
                    assert np.array_equal(got[k], want[k]), (cls, i, k)
                scale = max(float(np.abs(want["flow"]).max()), 1.0)
                assert float(np.abs(got["flow"] - want["flow"]).max()) \
                    <= 4e-5 * scale
    plain = tds.SceneFlow(aug_params={}, root=str(tree),
                          dstype="frames_finalpass", things_test=True)
    assert plain.augmentor is None
    assert plain.sample(0)["image1"].shape == (tp.EVAL_H, tp.EVAL_W, 3)
