"""The port's host data code (``tae_tpu_torch/data``, ``utils/meters``,
``utils/image_grid``) vs the JAX package's, on the CPU: the same PIL image
and numpy generator give the same arrays, the same shards the same samples
in the same order, the loaders the same batches. The native decoder is
built from ``native/taedata.cpp`` into a temporary build root and held to
the PIL path at ``tests/test_native.py``'s tolerances.
"""

import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tae_tpu.data import fake as jfake
from tae_tpu.data import imagefolder as jimagefolder
from tae_tpu.data import latents as jlatents
from tae_tpu.data import loader as jloader
from tae_tpu.data import tar_stream as jtar
from tae_tpu.data import transforms as jtf
from tae_tpu.utils import image_grid as jgrid
from tae_tpu.utils import meters as jmeters
from tae_tpu_torch.data import fake, imagefolder, latents, loader, native
from tae_tpu_torch.data import tar_stream as tar
from tae_tpu_torch.data import transforms as tf
from tae_tpu_torch.utils import image_grid, meters


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    for i in range(3):
        fake.make_fake_wds_shard(d / f"s-{i:06d}.tar", num_samples=7, size=40,
                                 seed=i)
    return d


def _image(seed: int, w: int = 53, h: int = 37):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return Image.fromarray(arr, "RGB")


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("seed", range(4))
def test_random_resized_crop_matches_jax(seed):
    img = _image(seed, 60 + 7 * seed, 45)
    a = tf.random_resized_crop_transform(32)(img, np.random.default_rng(seed))
    b = jtf.random_resized_crop_transform(32)(img, np.random.default_rng(seed))
    assert a.shape == (3, 32, 32) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("interpolation", ["bicubic", "bilinear", "nearest",
                                           "lanczos"])
def test_center_crop_transform_matches_jax(interpolation):
    img = _image(1)
    a = tf.center_crop_transform(24, pad=8, interpolation=interpolation)(img)
    b = jtf.center_crop_transform(24, pad=8, interpolation=interpolation)(img)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w, h", [(53, 37), (37, 53), (40, 40), (300, 20)])
def test_rrc_box_and_resize_helpers_match_jax(w, h):
    for seed in range(5):
        for scale, ratio in (((0.2, 1.0), (3 / 4, 4 / 3)),
                             ((0.9, 1.0), (3.0, 4.0))):
            assert tf._sample_rrc_box(np.random.default_rng(seed), w, h,
                                      scale, ratio) == \
                jtf._sample_rrc_box(np.random.default_rng(seed), w, h,
                                    scale, ratio)
    img = _image(2, w, h)
    assert tf.resize_shorter(img, 19).size == jtf.resize_shorter(img, 19).size
    np.testing.assert_array_equal(np.asarray(tf.center_crop(img, 17)),
                                  np.asarray(jtf.center_crop(img, 17)))


def test_to_array_and_normalize_match_jax():
    img = _image(3)
    np.testing.assert_array_equal(tf.to_array(img), jtf.to_array(img))
    np.testing.assert_array_equal(tf.to_array(img.convert("L")),
                                  jtf.to_array(img.convert("L")))
    x = tf.to_array(img)
    np.testing.assert_array_equal(tf.normalize(x), jtf.normalize(x))


def test_device_normalize_matches_host_normalize():
    img = _image(4)
    u8 = torch.from_numpy(np.asarray(img).transpose(2, 0, 1).copy())
    host = tf.normalize(tf.to_array(img))
    dev = tf.device_normalize(u8[None])[0].numpy()
    np.testing.assert_allclose(dev, host, atol=1e-5)


# ------------------------------------------------------------- tar streams

def test_fake_generators_write_the_jax_bytes(tmp_path):
    fake.make_fake_wds_shard(tmp_path / "a.tar", num_samples=3, size=24, seed=5)
    jfake.make_fake_wds_shard(tmp_path / "b.tar", num_samples=3, size=24, seed=5)
    assert (tmp_path / "a.tar").read_bytes() == (tmp_path / "b.tar").read_bytes()
    fake.make_fake_imagefolder(tmp_path / "fa", 2, 2, 24, seed=1)
    jfake.make_fake_imagefolder(tmp_path / "fb", 2, 2, 24, seed=1)
    for p in sorted((tmp_path / "fa").rglob("*.jpg")):
        assert p.read_bytes() == (tmp_path / "fb" / p.relative_to(
            tmp_path / "fa")).read_bytes()


def _tar_members(path):
    import tarfile

    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf.getmembers()]


# the learnable corpora (convergence runs, downstream fixtures) at a few
# small images: (generator, what it writes, its arguments)
LEARNABLE = [
    ("make_structured_wds_shard", "tar",
     dict(num_samples=3, size=24, num_classes=5, seed=3)),
    ("make_spectral_wds_shard", "tar",
     dict(num_samples=3, size=24, num_classes=5, seed=4, alpha=1.3)),
    ("make_classification_wds_shard", "tar",
     dict(num_samples=4, size=24, num_classes=3, seed=5)),
    ("make_structured_imagefolder", "folder",
     dict(num_images=3, size=24, seed=6)),
    ("make_spectral_imagefolder", "folder",
     dict(num_images=3, size=24, seed=7, alpha=0.8)),
    ("make_classification_imagefolder", "folder",
     dict(num_images=5, size=24, num_classes=3, seed=8)),
    ("_spectral_image", "array", dict(size=30, alpha=1.2)),
]


@pytest.mark.parametrize("name, kind, kw", LEARNABLE,
                         ids=[g[0] for g in LEARNABLE])
def test_learnable_corpora_write_the_jax_bytes(tmp_path, name, kind, kw):
    """The same seed gives the JAX package's bytes: tar member names and
    every member's bytes, file names and bytes, arrays exactly."""
    ours, theirs = getattr(fake, name), getattr(jfake, name)
    if kind == "array":
        for seed in (0, 9):
            np.testing.assert_array_equal(
                ours(np.random.default_rng(seed), **kw),
                theirs(np.random.default_rng(seed), **kw))
        return
    a, b = tmp_path / "a", tmp_path / "b"
    if kind == "tar":
        ours(a / "s.tar", **kw)
        theirs(b / "s.tar", **kw)
        got, want = _tar_members(a / "s.tar"), _tar_members(b / "s.tar")
        assert [n for n, _ in got] == [n for n, _ in want]
        assert len(got) == 2 * kw["num_samples"]
        assert got == want
        return
    ours(a, **kw)
    theirs(b, **kw)
    got = sorted(p.relative_to(a) for p in a.rglob("*.jpg"))
    assert got == sorted(p.relative_to(b) for p in b.rglob("*.jpg"))
    assert len(got) == kw["num_images"]
    for rel in got:
        assert (a / rel).read_bytes() == (b / rel).read_bytes()


def test_expand_shards_matches_jax(shards):
    for spec in (str(shards / "s-{000000..000002}.tar"),
                 str(shards / "s-*.tar"), [str(shards / "s-000001.tar")],
                 "pipe:cat x.tar", "https://host/s-{00..03}.tar"):
        assert tar.expand_shards(spec) == jtar.expand_shards(spec)


def _keys(reader, n=None):
    out = []
    for s in reader:
        out.append(s["__key__"] if isinstance(s, dict) else s)
        if n is not None and len(out) == n:
            break
    return out


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_single_pass_split_matches_jax(shards, count):
    """resampled=False (encoding): each worker's slice of the shards, in
    file order; a worker past the last shard yields nothing."""
    spec = str(shards / "s-{000000..000002}.tar")
    for i in range(count):
        a = tar.WebDatasetReader(tar.ShardSpec.from_string(spec, False),
                                 shard_index=i, shard_count=count)
        b = jtar.WebDatasetReader(jtar.ShardSpec.from_string(spec, False),
                                  shard_index=i, shard_count=count)
        assert _keys(a) == _keys(b)


@pytest.mark.parametrize("worker", [0, 1, 2])
def test_resampled_shuffled_stream_matches_jax(shards, worker):
    """resampled=True with a shuffle buffer (training): the same shard draws
    and the same shuffle order from the same seed."""
    spec = str(shards / "s-{000000..000002}.tar")
    kw = dict(shuffle_buffer=10, shard_index=worker, shard_count=3)
    a = tar.WebDatasetReader(tar.ShardSpec.from_string(spec, True, seed=7 + worker),
                             **kw)
    b = jtar.WebDatasetReader(jtar.ShardSpec.from_string(spec, True, seed=7 + worker),
                              **kw)
    ka = [(s["__key__"], len(s["jpg"])) for s in _take(a, 40)]
    kb = [(s["__key__"], len(s["jpg"])) for s in _take(b, 40)]
    assert ka == kb


def _take(reader, n):
    out = []
    for s in reader:
        out.append(s)
        if len(out) == n:
            return out
    return out


def test_decode_jpg_cls_matches_jax(shards):
    s = next(iter(tar.tar_samples(shards / "s-000000.tar")))
    img, cls = tar.decode_jpg_cls(s)
    jimg, jcls = jtar.decode_jpg_cls(s)
    assert cls == jcls and img.size == jimg.size
    np.testing.assert_array_equal(np.asarray(img), np.asarray(jimg))
    with pytest.raises(KeyError):
        tar.decode_jpg_cls({"__key__": "x", "cls": b"1"})


# ----------------------------------------------------- imagefolder, latents

def test_imagefolder_matches_jax(tmp_path):
    fake.make_fake_imagefolder(tmp_path, num_classes=3, per_class=2, size=40)
    t = tf.center_crop_transform(32, pad=8)
    a = imagefolder.ImageFolder(tmp_path, transform=t)
    b = jimagefolder.ImageFolder(tmp_path, transform=jtf.center_crop_transform(32, pad=8))
    assert a.classes == b.classes and a.samples == b.samples and len(a) == 6
    for (xa, ya), (xb, yb) in zip(a.iter_samples(1, 2), b.iter_samples(1, 2)):
        assert ya == yb
        np.testing.assert_array_equal(xa, xb)
    with pytest.raises(FileNotFoundError):
        imagefolder.ImageFolder(tmp_path / "missing")


def test_latents_reader_matches_jax(tmp_path):
    from tae_tpu_torch.cli.encode import ShardWriter

    rng = np.random.default_rng(0)
    w = ShardWriter(tmp_path, "p", shard_size=5)
    for _ in range(3):
        w.add(rng.standard_normal((4, 6, 3)).astype(np.float16),
              rng.integers(0, 9, 4).astype(np.int32))
    w.close()
    index = json.loads((tmp_path / "p_index.json").read_text())
    assert [s["num_samples"] for s in index["shards"]] == [5, 5, 2]
    for kw in (dict(), dict(shard_index=1, shard_count=2),
               dict(loop=False, seed=3)):
        a = list(latents.LatentDataset(tmp_path).iter_samples(**kw))
        b = list(jlatents.LatentDataset(tmp_path).iter_samples(**kw))
        assert len(a) == len(b)
        for (za, ta), (zb, tb) in zip(a, b):
            assert ta == tb
            np.testing.assert_array_equal(za, zb)
    # and the reference's monolithic dump, both ways
    n = latents.shards_to_pth(tmp_path / "p_index.json", tmp_path / "d.pth")
    assert n == 12
    a = list(latents.LatentDataset(tmp_path / "d.pth").iter_samples())
    b = list(jlatents.LatentDataset(tmp_path / "d.pth").iter_samples())
    assert [t for _, t in a] == [t for _, t in b]


# ------------------------------------------------------------------ loaders

def test_batched_and_collate_match_jax():
    samples = [(np.full(3, i), {"y": np.int32(i)}) for i in range(7)]
    a = list(loader.batched(iter(samples), 3))
    b = list(jloader.batched(iter(samples), 3))
    assert len(a) == len(b) == 3
    for (xa, da), (xb, db) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(da["y"], db["y"])
    assert len(list(loader.batched(iter(samples), 3, drop_last=True))) == 2


@pytest.fixture(scope="module")
def folder23(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder23")
    fake.make_fake_imagefolder(root, num_classes=1, per_class=23, size=8)
    return root


def test_batch_loader_workers_hand_batches_over_in_shared_memory(tmp_path):
    """Worker batches of a MiB or more cross as tensors in shared memory
    and arrive as the numpy arrays the inline loader gives (the workers
    interleave whole batches)."""
    fake.make_fake_imagefolder(tmp_path, num_classes=1, per_class=8, size=300)
    make = imagefolder.ImageFolder(tmp_path, transform=tf.to_array).iter_samples
    inline = list(loader.BatchLoader(make, 4))
    spread = list(loader.BatchLoader(make, 4, num_workers=2))
    assert inline[0][0].nbytes >= loader._SHARED_BYTES
    assert all(type(x) is np.ndarray and type(t) is np.ndarray
               for x, t in spread)

    def rows(batches):
        x = np.concatenate([b[0] for b in batches])
        return x[np.lexsort(x.reshape(len(x), -1).T)]

    np.testing.assert_array_equal(rows(spread), rows(inline))
    assert sorted(len(t) for _, t in spread) == [4, 4]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_batch_loader_rebatch_tail_is_one_partial_batch(folder23, num_workers):
    """rebatch keeps the dataset tail to one partial batch at any worker
    count (the reference's mean-of-batch-means eval), as the JAX loader
    does inline. (The workers are spawned: ``make_iter`` is a bound method
    of a port module's class, so a worker imports no test module.)"""
    make = imagefolder.ImageFolder(folder23, transform=tf.to_array).iter_samples
    a = list(loader.BatchLoader(make, 5, num_workers=num_workers,
                                rebatch=num_workers > 0))
    jmake = jimagefolder.ImageFolder(folder23,
                                     transform=jtf.to_array).iter_samples
    b = list(jloader.BatchLoader(jmake, 5))
    assert [len(x) for x, _ in a] == [len(x) for x, _ in b] == [5, 5, 5, 5, 3]
    got = np.concatenate([x for x, _ in a])
    want = np.concatenate([x for x, _ in b])
    order = np.lexsort(got.reshape(23, -1).T)   # workers interleave samples
    np.testing.assert_array_equal(got[order],
                                  want[np.lexsort(want.reshape(23, -1).T)])
    with pytest.raises(ValueError, match="mutually exclusive"):
        loader.BatchLoader(make, 5, prebatched=True, rebatch=True)


def test_device_prefetch_on_the_cpu_keeps_order_and_memory():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2) + i)
               for i in range(5)]
    out = list(loader.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 5
    for i, (x, y) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(y, torch.arange(2) + i)
    # a single array and a dict pass through too
    (z,) = loader.device_prefetch([np.zeros(4, np.uint8)], "cpu")
    assert z.dtype == torch.uint8
    (d,) = loader.device_prefetch([{"a": np.ones(2)}], "cpu")
    assert torch.equal(d["a"], torch.ones(2, dtype=torch.float64))


# ------------------------------------------------------------------ meters

def test_meters_match_jax(tmp_path):
    a, b = meters.MetricLogger(), jmeters.MetricLogger()
    for i, v in enumerate([3.0, 1.0, 4.0, 1.5, 9.0]):
        a.update(loss=torch.tensor(v), lr=np.float32(0.1 * i), skip=None)
        b.update(loss=v, lr=np.float32(0.1 * i), skip=None)
    assert str(a) == str(b)
    assert a.global_avgs() == pytest.approx(b.global_avgs())
    assert a.loss.median == b.loss.median and a.loss.max == b.loss.max
    a.synchronize_between_processes()
    assert a.loss.count == 5
    meters.append_jsonl(tmp_path / "l.txt", {"train_loss": 1.0, "iteration": 3})
    jmeters.append_jsonl(tmp_path / "j.txt", {"train_loss": 1.0, "iteration": 3})
    assert (tmp_path / "l.txt").read_text() == (tmp_path / "j.txt").read_text()
    seen = list(a.log_every(range(3), 1, header="h"))
    assert seen == [0, 1, 2]


def test_image_grid_matches_jax(tmp_path):
    imgs = np.random.default_rng(0).standard_normal((11, 3, 5, 6))
    np.testing.assert_array_equal(image_grid.make_grid(imgs, nrow=4),
                                  jgrid.make_grid(imgs, nrow=4))
    image_grid.save_image(imgs, tmp_path / "a.png", nrow=4)
    jgrid.save_image(imgs, tmp_path / "b.png", nrow=4)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


# ------------------------------------------------------------ native decoder

@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The port's libtaedata.so, built into a temporary root."""
    if shutil.which("g++") is None or not Path("/usr/include/jpeglib.h").exists():
        pytest.skip("g++ or libjpeg's header is missing: the native decoder "
                    "cannot be built here")
    root = tmp_path_factory.mktemp("native_build")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_ROOT", root)
    mp.setenv("TAE_TPU_NATIVE", "1")
    assert native.available() and native.decoder_name() == "native"
    assert native._lib_path(root).is_file()
    yield
    mp.undo()


@pytest.fixture(scope="module")
def smooth_jpeg():
    from PIL import Image

    base = np.random.default_rng(0).integers(30, 220, (12, 16, 3)).astype(np.uint8)
    arr = np.asarray(Image.fromarray(base, "RGB").resize(
        (160, 120), Image.Resampling.BILINEAR))
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def test_native_decode_matches_pil(native_lib, smooth_jpeg):
    """Fused native decode + box resize + normalize vs PIL; float resampling
    against PIL's fixed point: tests/test_native.py's bounds (normalized
    units, 0.02 ~ one of 255 levels)."""
    from PIL import Image

    box = (8.0, 4.0, 130.0, 100.0)
    out = native.decode_to_tensor(smooth_jpeg, box, 64, filter=native.BICUBIC)
    pil = Image.open(io.BytesIO(smooth_jpeg)).convert("RGB")
    ref = tf.normalize(tf.to_array(pil.resize((64, 64), Image.Resampling.BICUBIC,
                                              box=box)))
    assert out.shape == (3, 64, 64)
    assert np.abs(out - ref).mean() < 0.02
    assert np.abs(out - ref).max() < 0.25
    assert native.jpeg_size(smooth_jpeg) == (160, 120)


def test_native_center_crop_matches_pil(native_lib, smooth_jpeg):
    from PIL import Image

    out = native.center_crop(smooth_jpeg, 64, pad=32)
    ref = tf.center_crop_transform(64, pad=32)(
        Image.open(io.BytesIO(smooth_jpeg)).convert("RGB"))
    assert out.shape == ref.shape == (3, 64, 64)
    assert np.abs(out - ref).mean() < 0.06


def test_native_batch_decode_matches_single(native_lib, smooth_jpeg):
    datas = [smooth_jpeg] * 4 + [b"not a jpeg"]
    boxes = np.tile(np.asarray([0, 0, 160, 120], np.float32), (5, 1))
    flips = np.asarray([0, 1, 0, 0, 0], np.int32)
    out, keep = native.decode_batch(datas, boxes, flips, 32, threads=2,
                                    skip_failed=True)
    assert out.shape == (4, 3, 32, 32) and keep.tolist() == [1, 1, 1, 1, 0]
    single = native.decode_to_tensor(smooth_jpeg, (0, 0, 160, 120), 32)
    np.testing.assert_allclose(out[0], single, atol=1e-6)
    np.testing.assert_allclose(out[1], single[:, :, ::-1], atol=1e-6)
    u8, _ = native.decode_batch_u8(datas[:4], boxes[:4], flips[:4], 32,
                                   skip_failed=True)
    dev = tf.device_normalize(torch.from_numpy(u8)).numpy()
    assert np.abs(dev[0] - single).mean() < 0.02


def test_native_off_means_pil(monkeypatch):
    monkeypatch.setenv("TAE_TPU_NATIVE", "0")
    assert not native.available() and native.decoder_name() == "pil"
