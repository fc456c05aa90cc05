"""Port parity: the JPEG feed without libjpeg, against the JAX package's native loader.

The port decodes with Pillow and letterboxes with ``ops/letterbox.py``
(the plain version on the CPU); the JAX package's ``native_loader`` runs
``native/loader.cpp`` (libjpeg, a C++ resize). Seeded JPEGs written with
Pillow go through both, at S = 416 and 640:

  * COCO-like sizes, the extremes 1 x N, N x 1 and 97 x 1203, 4:2:0, 4:2:2
    and 4:4:4 subsampling, grayscale, progressive, baseline files truncated
    at several cuts: canvases, sizes and failure counts bitwise equal
    (``decode_resize_pad`` and ``pack_batch``); CMYK and bytes that are not a
    JPEG fail in both;
  * the plain letterbox on raw arrays against ``resize_pad_raw``, bitwise;
  * a truncated file still raises in the host pipeline's reader;
  * one case is not bitwise: a truncated PROGRESSIVE file. The JAX package
    links the system's libjpeg-turbo (2.1.5 here), Pillow bundles its own
    (3.1.3), and the two fill a progressive file's missing scans
    differently. The port equals Pillow's own truncated-file decode (its
    process-wide ``LOAD_TRUNCATED_IMAGES``) bitwise, and the JAX library
    on the sizes; the pixel gap is the libraries', measured and printed by
    ``test_truncated_progressive_follows_pillows_libjpeg`` (``-s``);
  * with the JAX package's library made unloadable, the port's whole JPEG
    path (``DeviceCorpus.decode``, the sharded decode, the host-fed groups
    with and without the RAM cache, the validation cache) still runs and
    equals the JAX package's canvases.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data import native_loader as t_native
from object_detection_cib_torch.data import reader as treader
from object_detection_cib_torch.data.cache import DatasetInfo, ImageMetadata, SampleInfo, TargetInfo, XYXYBox
from object_detection_cib_torch.data.host_augment import AugParams as TAug
from object_detection_cib_torch.data.val_cache import ValDeviceCache as TValCache
from object_detection_cib_torch.ops import letterbox as tlb
from object_detection_cib_torch.parallel.mesh import DataMesh
from object_detection_cib_tpu.data import device_pipeline as jdp
from object_detection_cib_tpu.data import native_loader as j_native
from object_detection_cib_tpu.data import reader as jreader
from object_detection_cib_tpu.data.host_augment import AugParams as JAug
from object_detection_cib_tpu.data.val_cache import ValDeviceCache as JValCache

SIZES = [(480, 640), (640, 480), (427, 640), (375, 500),  # COCO-like (h, w)
         (1, 517), (517, 1), (1203, 97)]  # the extremes
TARGETS = [416, 640]


def _image(h, w, seed):
    """Smooth gradients and noise: content that resizing does not leave alone."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) * 7 % 256], -1)
    return np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(img, mode="RGB", **kw):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _cases():
    """{name: bytes}: the decodable cases, then the failures."""
    cases = {f"{h}x{w}": _jpeg(_image(h, w, i), quality=90) for i, (h, w) in enumerate(SIZES)}
    a = _image(427, 640, 9)
    for name, sub in (("420", 2), ("422", 1), ("444", 0)):
        cases[f"subsampling_{name}"] = _jpeg(a, subsampling=sub)
    cases["grayscale"] = _jpeg(a, "L")
    cases["progressive"] = _jpeg(a, progressive=True)
    full = _jpeg(a, quality=90)
    for frac in (0.3, 0.5, 0.7, 0.9, 0.99):
        cases[f"truncated_{frac}"] = full[:int(len(full) * frac)]
    cases["cmyk"] = _jpeg(a, "CMYK")
    cases["not_a_jpeg"] = b"\xff\xd8 these bytes are not a JPEG"
    png = io.BytesIO()
    Image.fromarray(a).save(png, format="PNG")
    cases["png"] = png.getvalue()
    return cases


CASES = _cases()
FAILING = ("cmyk", "not_a_jpeg", "png")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain letterbox gains little from torch's intra-op threads here,
    and beside other test workers those threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S", TARGETS)
@pytest.mark.parametrize("name", list(CASES))
def test_decode_resize_pad_matches_jax(name, S):
    buf = CASES[name]
    if name in FAILING:
        for decode in (j_native.decode_resize_pad, t_native.decode_resize_pad):
            with pytest.raises(ValueError, match="JPEG decode failed"):
                decode(buf, S)
        return
    want, wh, ww = j_native.decode_resize_pad(buf, S)
    got, gh, gw = t_native.decode_resize_pad(buf, S)
    assert (gh, gw) == (wh, ww)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", TARGETS)
def test_pack_batch_matches_jax(S):
    names = list(CASES)
    bufs = [CASES[k] for k in names]
    want, wsizes, wfails = j_native.pack_batch(bufs, S)
    got, gsizes, gfails = t_native.pack_batch(bufs, S, num_threads=4)
    assert gfails == wfails == len(FAILING)
    np.testing.assert_array_equal(gsizes, wsizes)
    ok = wsizes[:, 0] > 0
    assert [n for n, o in zip(names, ok) if not o] == list(FAILING)
    np.testing.assert_array_equal(got[ok], want[ok])
    assert (got[~ok] == tlb.FILL).all()  # a failed file: a canvas of 114 (loader.cpp leaves it unwritten)
    # into a caller's array, as the JAX signature allows
    out = np.zeros_like(got)
    assert t_native.pack_batch(bufs, S, out=out)[0] is out
    np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1), (2, 3), (97, 1203), (1203, 97), (333, 500),
                                (416, 416), (640, 640), (700, 416)])
@pytest.mark.parametrize("S", [64, 63, 416, 640])
def test_plain_letterbox_matches_resize_pad_raw(hw, S):
    img = _image(*hw, seed=sum(hw) + S)
    want, wh, ww = j_native.resize_pad_raw(img, S)
    got, gh, gw = t_native.resize_pad_raw(img, S)
    assert (gh, gw) == (wh, ww) == tlb.content_size(*hw, S)
    np.testing.assert_array_equal(got, want)


def test_letterbox_centres_and_fills_failures():
    """``center`` places the content at ((S - nh) // 2, (S - nw) // 2), the
    validation cache's letterbox; an image of size (0, 0) gives 114 and sizes
    (0, 0); the output may be a view of any strides."""
    imgs = [_image(30, 50, 1), None, _image(50, 20, 2)]
    raw = t_native.RawImages.from_arrays(imgs)
    assert raw.failures == 1 and raw.hw.tolist() == [[30, 50], [0, 0], [50, 20]]
    top = torch.zeros((3, 3, 40, 40), dtype=torch.uint8)
    sizes = tlb.letterbox(*raw[:3], top)
    nhwc = torch.zeros((3, 40, 40, 3), dtype=torch.uint8)
    assert torch.equal(tlb.letterbox(*raw[:3], nhwc.permute(0, 3, 1, 2), center=True), sizes)
    assert sizes.tolist() == [[24, 40], [0, 0], [40, 16]]
    assert (top[1] == tlb.FILL).all() and (nhwc[1] == tlb.FILL).all()
    for i, (nh, nw) in enumerate(sizes.tolist()):
        t, le = (40 - nh) // 2, (40 - nw) // 2
        assert torch.equal(nhwc[i, t:t + nh, le:le + nw], top[i, :, :nh, :nw].permute(1, 2, 0))
        assert int((nhwc[i] != tlb.FILL).any(-1).sum()) <= nh * nw


def test_fma_f32_rounds_once():
    """The plain version's fused multiply-add against exact rational
    arithmetic: random values, cancellations, and values built so that
    rounding twice (to f64, then to f32) goes the wrong way."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    n = 3000
    a = rng.uniform(-300, 300, n).astype(np.float32)
    b = rng.uniform(0, 1, n).astype(np.float32)
    c = np.concatenate([rng.uniform(-300, 300, n // 3),  # general
                        -(a[n // 3:2 * n // 3].astype(np.float64) * b[n // 3:2 * n // 3])
                        * (1 + rng.uniform(-1e-7, 1e-7, n // 3)),  # cancellation
                        rng.uniform(-1, 1, n - 2 * (n // 3)) * 2.0 ** -30]).astype(np.float32)  # tiny
    # a * b just below half an ulp of c, whose last bit is odd: rounded to
    # f64 first, the sum lands on the midpoint and ties to even, upwards
    e = np.float32(2.0 ** -23)
    built = [(np.float32(2.0 ** -12) * (1 + e) * abs(sc), np.float32(2.0 ** -12) * (1 - e) * np.sign(sc),
              (1 + e) * sc) for sc in (np.float32(1), np.float32(-1), np.float32(2.0 ** 7))]
    a, b, c = (np.concatenate([v, [t[k] for t in built]]).astype(np.float32) for k, v in enumerate((a, b, c)))
    got = tlb.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.int32)) & 1))
        assert g == best, (x, y, z)
    assert (twice[-len(built):] != got[-len(built):]).all()  # the built cases do catch double rounding


def test_truncated_file_still_raises_in_the_host_reader(tmp_path):
    """The port's decode reads a truncated file per call; Pillow's
    process-wide switch stays off, so the host pipeline's reader raises on
    the file as the JAX package's does."""
    path = tmp_path / "cut.jpg"
    path.write_bytes(CASES["truncated_0.5"])
    sample = SampleInfo("cut", "cut.jpg", ImageMetadata(640, 427, 3, "image/jpeg", 0), [])
    assert t_native.decode_jpeg(path.read_bytes()) is not None
    assert ImageFile.LOAD_TRUNCATED_IMAGES is False
    for read in (treader.read_image, jreader.read_image):
        with pytest.raises(OSError, match="truncated"):
            read(tmp_path, sample)


def test_truncated_progressive_follows_pillows_libjpeg():
    full = CASES["progressive"]
    for frac in (0.1, 0.3, 0.5, 0.7):
        buf = full[:int(len(full) * frac)]
        ImageFile.LOAD_TRUNCATED_IMAGES = True
        try:
            with Image.open(io.BytesIO(buf)) as im:
                pillow = np.asarray(im.convert("RGB"))
        finally:
            ImageFile.LOAD_TRUNCATED_IMAGES = False
        np.testing.assert_array_equal(t_native.decode_jpeg(buf), pillow)
        for S in TARGETS:
            want, wsizes, wfails = j_native.pack_batch([buf], S)
            got, gsizes, gfails = t_native.pack_batch([buf], S)
            assert gfails == wfails == 0
            np.testing.assert_array_equal(gsizes, wsizes)
            diff = np.abs(got.astype(np.int16) - want)
            print(f"truncated progressive, cut at {frac} of {len(full)} B, S={S}: max difference "
                  f"{int(diff.max())}/255 on {float((diff > 0).mean()):.6f} of the canvas's values")


# ---------------------------------------------- the JPEG path without libjpeg

@pytest.fixture
def no_libjpeg(monkeypatch):
    """The JAX package's library made unloadable for the port."""

    def refuse(*a, **k):
        raise AssertionError("the port's JPEG path loaded native/libodcib.so")

    monkeypatch.setattr(t_native, "build", refuse)
    monkeypatch.setattr(t_native, "get_lib", refuse)
    monkeypatch.setattr(t_native, "_open", refuse)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, info): the decodable cases as a dataset of one box each."""
    root = tmp_path_factory.mktemp("jpeg-cases")
    samples = []
    for k, (name, buf) in enumerate((n, b) for n, b in CASES.items() if n not in FAILING):
        (root / f"{name}.jpg").write_bytes(buf)
        with Image.open(io.BytesIO(buf)) as im:
            w, h = im.size
        box = TargetInfo(XYXYBox(0.0, 0.0, w / 2 + 1, h / 2 + 1), f"c{k % 3}")
        samples.append(SampleInfo(f"s{k}", f"{name}.jpg", ImageMetadata(w, h, 3, "image/jpeg", 0), [box]))
    return root, DatasetInfo("jpeg-cases", None, ["c0", "c1", "c2"], samples)


S_SMALL = 96  # the canvases of this section


def _jax_corpus(info, root):
    jp = jdp.DeviceDataPipeline(info, target_size=S_SMALL, batch_size=4, aug_params=JAug(), max_targets=8,
                                seed=0, root_dir=root, fake_mode=False, device_cache=True,
                                corpus_layout="planar")
    return np.asarray(jp._ds_images), np.asarray(jp._ds_sizes)


def test_device_corpus_decode_without_libjpeg(corpus, no_libjpeg, monkeypatch):
    root, info = corpus
    monkeypatch.setattr(tdp, "DECODE_ROWS", 5)  # several chunks, a ragged last one
    got = tdp.DeviceCorpus.decode(info, S_SMALL, "cpu", root)
    want_images, want_sizes = _jax_corpus(info, root)
    np.testing.assert_array_equal(got.images.numpy(), want_images)
    np.testing.assert_array_equal(got.sizes.numpy(), want_sizes)


def test_sharded_decode_without_libjpeg(corpus, no_libjpeg, monkeypatch):
    """Each of 3 ranks decodes only its rows (the all-gather of the sizes
    played by the test from each rank's own rows)."""
    import torch.distributed as dist

    root, info = corpus
    want_images, want_sizes = _jax_corpus(info, root)
    n, ranks = len(info.samples), 3
    per = -(-n // ranks)
    decoded = []
    real = tdp.decode_canvases

    def counting(info_, indices, *a, **k):
        decoded.append(list(indices))
        return real(info_, indices, *a, **k)

    monkeypatch.setattr(tdp, "decode_canvases", counting)
    own = {}

    def all_gather(parts, t, group=None):  # each rank's padded sizes, from the JAX package's
        for r, p in enumerate(parts):
            p.zero_()
            lo, hi = min(r * per, n), min((r + 1) * per, n)
            p[:hi - lo] = torch.from_numpy(want_sizes[lo:hi].copy())
        own[len(own)] = t.clone()

    monkeypatch.setattr(dist, "all_gather", all_gather)
    for r in range(ranks):
        mesh = DataMesh(ranks, r, torch.device("cpu"), group=object(), backend="gloo")
        shard = tdp.DeviceCorpus.sharded(info, S_SMALL, mesh, fake_mode=False, root_dir=root)
        lo, hi = min(r * per, n), min((r + 1) * per, n)
        assert decoded[-1] == list(range(lo, hi))
        assert shard.images.shape[0] == per and shard.row0 == r * per
        np.testing.assert_array_equal(shard.images[:hi - lo].numpy(), want_images[lo:hi])
        assert not shard.images[hi - lo:].any()  # zero rows past N
        np.testing.assert_array_equal(own[r][:hi - lo].numpy(), want_sizes[lo:hi])  # its own sizes
        np.testing.assert_array_equal(shard.sizes.numpy(), want_sizes)


@pytest.mark.parametrize("ram_cache", [False, True])
def test_host_fed_groups_without_libjpeg(corpus, no_libjpeg, ram_cache):
    root, info = corpus
    kw = dict(max_targets=8, seed=0, root_dir=root, fake_mode=False, device_cache=False,
              enable_ram_cache=ram_cache)
    tp = tdp.DeviceDataPipeline(info, S_SMALL, 2, TAug(), device="cpu", **kw)
    jp = jdp.DeviceDataPipeline(info, target_size=S_SMALL, batch_size=2, aug_params=JAug(), **kw)
    groups = jp._epoch_plan()[0]
    for group in list(groups) * 2:
        got = tp.upload(tp._load_group(group), torch.from_numpy(np.asarray(group, np.int64)))
        want = jp._load_group(group)
        np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images).transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    held, nbytes = tp.ram_cache_held()
    if ram_cache:
        seen = np.unique(groups)
        sizes = {s: info.samples[s].image_metadata for s in seen}
        assert held == len(seen) and nbytes == sum(m.height * m.width * 3 for m in sizes.values())
    else:
        assert (held, nbytes) == (0, 0)


def test_val_cache_without_libjpeg(corpus, no_libjpeg):
    root, info = corpus
    idx = np.arange(len(info.samples))[::-1]  # any order of the set
    got = TValCache(info, idx, S_SMALL, 8, fake_mode=False, root_dir=root)
    want = JValCache(info, idx, S_SMALL, 8, fake_mode=False, root_dir=root)
    assert got.canvases.dtype == torch.uint8 and got.canvases.device.type == "cpu"
    for name in ("canvases", "gt_boxes", "gt_labels", "gt_mask", "indices"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), getattr(want, name), err_msg=name)
