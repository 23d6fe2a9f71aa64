"""The port's data layer (data/png.py, data/dataset.py, data/augment.py)
against OpenCV and the JAX package's: the PNG reader against
``cv2.imread`` (converted to RGB) on ``cv2.imwrite`` output and on every row
filter of the port's writer; the dataset's items and the loaders' batches
equal to JAX's, over two epochs and two shards; the device-resident loader
equal to the host loader; the augmentation's annealed strengths equal to
JAX's exactly, and each op equal to JAX's own op given the same draws (to
1e-4 in [0, 255], float32 sums in other orders)."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.data import augment as jax_aug
from autonomous_driving_with_diffusion_model_tpu.data.dataset import Loader as JaxLoader
from autonomous_driving_with_diffusion_model_tpu.data.dataset import TrajDataset as JaxDataset
from autonomous_driving_with_diffusion_model_tpu_torch.data import augment as aug
from autonomous_driving_with_diffusion_model_tpu_torch.data import (
    DeviceResidentLoader,
    Loader,
    TrajDataset,
    maybe_device_resident,
    read_png,
    write_png,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each makes
# them contend for the cores (these files ran 3.6x as long)
torch.set_num_threads(1)

HW = (32, 48)


def _images(rng):
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    smooth = np.stack([(xx * 5) % 256, (yy * 7) % 256, (xx + yy) % 256], -1).astype(np.uint8)
    return {"random": rng.integers(0, 256, (*HW, 3), dtype=np.uint8), "smooth": smooth}


@pytest.mark.parametrize("content", ["random", "smooth"])
@pytest.mark.parametrize("level", [1, 9])
def test_png_reader_matches_cv2(tmp_path, rng, content, level):
    img = _images(rng)[content]
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (*HW, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_filters_read_back(tmp_path, rng, filters, channels):
    """Every row filter of the writer (one for the image, or one per row),
    grey, RGB and RGBA: cv2 and the port read the same RGB (grey repeated,
    alpha dropped)."""
    img = rng.integers(0, 256, (*HW, channels), dtype=np.uint8)
    kinds = rng.integers(0, 5, HW[0]) if filters == "mixed" else filters
    path = str(tmp_path / "f.png")
    write_png(path, img[..., 0] if channels == 1 else img, kinds)
    want = np.repeat(img, 3, axis=2) if channels == 1 else img[..., :3]
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), want)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


@pytest.mark.parametrize("case", ["16-bit", "interlaced", "palette", "crc", "not-png"])
def test_png_reader_refuses_what_it_does_not_read(tmp_path, case):
    path = str(tmp_path / "f.png")
    if case == "16-bit":
        cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))
    elif case == "not-png":
        open(path, "wb").write(b"GIF89a")
    else:
        depth, ctype, interlace = 8, (3 if case == "palette" else 2), int(case == "interlaced")
        ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace))
        if case == "crc":
            ihdr = ihdr[:-1] + bytes([ihdr[-1] ^ 1])
        data = _chunk(b"IDAT", zlib.compress(bytes(2 * 7)))
        open(path, "wb").write(b"\x89PNG\r\n\x1a\n" + ihdr + data + _chunk(b"IEND", b""))
    with pytest.raises(ValueError):
        read_png(path)


def _write_dataset(root, n, rng, rows=16):
    os.makedirs(os.path.join(root, "front"))
    os.makedirs(os.path.join(root, "waypoints"))
    for i in range(n):
        cv2.imwrite(os.path.join(root, "front", f"{i:06d}.png"), rng.integers(0, 256, (*HW, 3), dtype=np.uint8))
        lines = [" ".join(f"{v:.5f}" for v in rng.uniform(-1, 1, 2))]
        lines += [" ".join(f"{v:.5f}" for v in rng.uniform(-1.5, 1.5, 7)) for _ in range(rows)]
        with open(os.path.join(root, "waypoints", f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n\n")


def test_dataset_items_match_jax(tmp_path, rng):
    """Sorted front/*.png, RGB uint8 frames, the target on line 0 and 16 rows
    clipped to [-1, 1], the decoded cache; a file of other than 16 rows
    raises."""
    root = str(tmp_path / "d")
    _write_dataset(root, 5, rng)
    ours, theirs = TrajDataset(root), JaxDataset(root)
    assert len(ours) == len(theirs) == 5 and ours.front_image == theirs.front_image
    for i in range(5):
        a, b = ours[i], theirs[i]
        for k in ("image", "trajs", "target"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a["trajs"].shape == (16, 7) and np.abs(a["trajs"]).max() <= 1.0
    assert ours[0] is ours[0]  # cached
    bad = str(tmp_path / "bad")
    _write_dataset(bad, 1, rng, rows=15)
    with pytest.raises(ValueError, match="15 rows"):
        TrajDataset(bad)[0]
    with pytest.raises(FileNotFoundError):
        TrajDataset(str(tmp_path / "none"))


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_loader_batches_match_jax(tmp_path, rng, shard):
    """The same batches in the same order as JAX's Loader, for two epochs:
    the (seed + epoch) permutation, the shard's stride, drop-last."""
    root = str(tmp_path / "d")
    _write_dataset(root, 11, rng)
    kw = dict(batch_size=2, num_workers=2, seed=3, shard_index=shard[0], shard_count=shard[1])
    ours, theirs = Loader(TrajDataset(root), **kw), JaxLoader(JaxDataset(root), **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            for k in ("image", "trajs", "target"):
                np.testing.assert_array_equal(a[k], b[k])


def test_loader_raises_a_workers_error(tmp_path, rng):
    """A frame that fails to decode raises in the consumer, not a hang."""
    root = str(tmp_path / "d")
    _write_dataset(root, 4, rng)
    with open(os.path.join(root, "front", "000002.png"), "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        list(Loader(TrajDataset(root), batch_size=2, num_workers=2, shuffle=False))


def test_device_resident_loader_matches_host_loader(tmp_path, rng):
    root = str(tmp_path / "d")
    _write_dataset(root, 7, rng)
    host = Loader(TrajDataset(root), batch_size=3, seed=1)
    resident = DeviceResidentLoader(Loader(TrajDataset(root), batch_size=3, seed=1), "cpu")
    assert len(resident) == len(host) == 2 and resident.nbytes() == 7 * (HW[0] * HW[1] * 3 + 16 * 7 * 4 + 8)
    for _ in range(2):
        for a, b in zip(resident, host):
            for k in ("image", "trajs", "target"):
                assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
                np.testing.assert_array_equal(a[k].numpy(), b[k])
    cfg = create_cfg()
    for mode, limit, want in (("off", 1 << 30, Loader), ("on", 0, DeviceResidentLoader),
                              ("auto", 1 << 30, DeviceResidentLoader), ("auto", 100, Loader)):
        cfg.TPU.DEVICE_DATA, cfg.TPU.DEVICE_DATA_MAX_BYTES = mode, limit
        assert type(maybe_device_resident(Loader(TrajDataset(root), batch_size=3), cfg, "cpu")) is want


@pytest.mark.parametrize("iteration", [0, 32, 12345, 3.2e6, 1e7, 7777777, 6.4e8])
def test_augment_factors_equal_jax(iteration):
    want = jax_aug.augment_factors(jnp.asarray(iteration, jnp.float32))
    got = aug.augment_factors(iteration)
    assert set(got) == set(want)
    for k in want:
        assert np.float32(got[k]) == np.float32(want[k]), k


def _op_case(seed, iteration=3.2e7):
    """An image, JAX's factors and op key, the port's factors."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (*HW, 3)).astype(np.float32)
    return x, jax_aug.augment_factors(jnp.asarray(iteration, jnp.float32)), jax.random.PRNGKey(seed)


def _close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_ops_match_jax_given_the_draws(seed):
    """Each op against JAX's own, fed the draws JAX's op takes from its key
    (the same splits): blur (sigma), additive noise (scale and the normal
    fields), coarse dropout (its 1/8 grid mask, resized nearest), dropout,
    add, multiply, linear contrast (per-channel or shared values)."""
    x, f, key = _op_case(seed)
    t = torch.from_numpy(x)[None]
    per_c = bool(jax.random.bernoulli(key, f["color"]))
    H, W, C = x.shape
    # blur
    sigma = float(jax.random.uniform(key, ()) * f["blur"])
    _close(aug._blur(t, torch.tensor([sigma])), jax_aug._gaussian_blur(jnp.asarray(x), key, f))
    assert torch.equal(aug._blur(t, torch.tensor([0.0])), t)
    # additive noise
    r1, r2, r3 = jax.random.split(key, 3)
    scale = float(jax.random.uniform(r1, ()) * f["dropout"] * 255.0)
    z = np.asarray(jax.random.normal(r2, x.shape)) if per_c else np.broadcast_to(
        np.asarray(jax.random.normal(r3, (H, W, 1))), x.shape)
    _close(aug._add_noise(t, torch.tensor([scale]), torch.from_numpy(np.ascontiguousarray(z))[None]),
           jax_aug._additive_noise(jnp.asarray(x), key, f))
    # coarse dropout and dropout
    p = jax.random.uniform(r1, ()) * f["dropout"]
    for name, shape, ours in (("_coarse_dropout", (max(H // 8, 1), max(W // 8, 1)), aug._coarse_dropout),
                              ("_dropout", (H, W), aug._dropout)):
        mask = (jax.random.bernoulli(r2, p, shape + (C,)) if per_c
                else jnp.broadcast_to(jax.random.bernoulli(r3, p, shape + (1,)), shape + (C,)))
        _close(ours(t, torch.from_numpy(np.asarray(mask, np.float32))[None]),
               getattr(jax_aug, name)(jnp.asarray(x), key, f))
    # add, multiply, contrast: per-channel or one value
    q1, q2 = jax.random.split(key)
    for name, lo, hi, ours in (("_add", -f["add"], f["add"], aug._add),
                               ("_multiply", f["mul_neg"], f["mul_pos"], aug._multiply),
                               ("_linear_contrast", f["contrast_neg"], f["contrast_pos"], aug._contrast)):
        v = (jax.random.uniform(q1, (1, 1, C), minval=lo, maxval=hi) if per_c
             else jnp.broadcast_to(jax.random.uniform(q2, (), minval=lo, maxval=hi), (1, 1, C)))
        _close(ours(t, torch.from_numpy(np.asarray(v))[None]), getattr(jax_aug, name)(jnp.asarray(x), key, f))


def test_coarse_mask_resizes_like_jax():
    mask = np.random.default_rng(0).integers(0, 2, (4, 6, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(mask), (32, 50, 3), "nearest")
    got = aug._nearest_up(torch.from_numpy(mask)[None], 32, 50)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_batch_contract():
    """float32 in [0, 255] of the input's shape; one generator seed gives one
    output, another a different one; at a late iteration (every op at
    frequency 0.5) most images change, at iteration 0 (0.05) most do not."""
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (16, *HW, 3), dtype=np.uint8))
    late = aug.augment_batch(images, torch.Generator().manual_seed(1), 6.4e8)
    assert late.dtype == torch.float32 and late.shape == images.shape
    assert late.min() >= 0 and late.max() <= 255
    assert torch.equal(late, aug.augment_batch(images, torch.Generator().manual_seed(1), 6.4e8))
    assert not torch.equal(late, aug.augment_batch(images, torch.Generator().manual_seed(2), 6.4e8))
    changed = lambda out: sum(not torch.equal(o, i.float()) for o, i in zip(out, images))
    assert changed(late) >= 12
    assert changed(aug.augment_batch(images, torch.Generator().manual_seed(1), 0)) <= 8
