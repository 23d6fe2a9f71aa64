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
from autonomous_driving_with_diffusion_model_tpu_torch.data.png import read_pngs
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


def _write_filtered(root, n, rng, filt):
    """``n`` samples whose frames the port's writer filters with ``filt``
    (1 Sub, 4 Paeth; a list is one filter per row)."""
    _write_dataset(root, n, rng)
    for i in range(n):
        path = os.path.join(root, "front", f"{i:06d}.png")
        write_png(path, rng.integers(0, 256, (*HW, 3), dtype=np.uint8), filt)


@pytest.mark.parametrize("filt", [1, 4, ([0, 1, 2, 3, 4] * 7)[:HW[0]]], ids=["sub", "paeth", "every"])
def test_decoder_processes_give_jax_batches_and_read_png_frames(tmp_path, rng, filt):
    """Frames of Sub rows, of Paeth rows and of every filter: the decoder
    processes' batches equal JAX's Loader's, their frames ``read_png``'s,
    over two epochs of one pool of processes; a batch taken while an
    earlier iteration was left midway is still this epoch's."""
    root = str(tmp_path / "d")
    _write_filtered(root, 9, rng, filt)
    ds = TrajDataset(root)
    ours, theirs = Loader(ds, batch_size=2, num_workers=3, seed=5), JaxLoader(JaxDataset(root), batch_size=2, seed=5)
    try:
        next(iter(ours))  # an iteration left after one batch
        theirs._epoch += 1
        for _ in range(2):
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == 4
            for a, b in zip(got, want):
                for k in ("image", "trajs", "target"):
                    np.testing.assert_array_equal(a[k], b[k])
        procs = ours._pool.procs
        assert len(procs) == 3 and all(p.is_alive() for p in procs)
    finally:
        ours.close()
    assert not any(p.is_alive() for p in procs)
    shuffled = Loader(ds, batch_size=3, num_workers=2, shuffle=False)
    try:
        for bi, batch in enumerate(shuffled):
            want = np.stack([read_png(ds.front_image[i]) for i in range(3 * bi, 3 * bi + 3)])
            np.testing.assert_array_equal(batch["image"], want)
    finally:
        shuffled.close()


def test_loader_raises_when_a_worker_dies(tmp_path, rng):
    """A decoder process that dies (killed here) makes the consumer raise,
    naming its exit code, and the next epoch raises too; nothing falls back
    to threads."""
    import signal

    root = str(tmp_path / "d")
    _write_dataset(root, 8, rng)
    loader = Loader(TrajDataset(root), batch_size=2, num_workers=2, shuffle=False)
    try:
        it = iter(loader)
        next(it)
        victim = loader._pool.procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join()
        with pytest.raises(RuntimeError, match=f"pid {victim.pid}.*exited with code -9"):
            list(it)
        with pytest.raises(RuntimeError, match="exited"):
            list(loader)
    finally:
        loader.close()


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


def _composed(images, d):
    """The reference the branch-free body is held to: each image alone, its
    ops applied one after another in its own order where they apply, each
    op the plain function of its draws for that image."""
    out = []
    for b in range(images.shape[0]):
        x = images[b:b + 1].to(torch.float32)
        per_c = d["per_c"][b:b + 1]
        for k in range(7):
            (js,) = torch.nonzero(d["select"][k, :, b], as_tuple=True)
            for j in js.tolist():
                if j == 0:
                    x = aug._separable(x, d["blur_taps"][b:b + 1])
                elif j == 1:
                    x = aug._add_noise(x, d["noise_scale"][b:b + 1],
                                       aug._channel_choice(per_c[:, 1], d["noise"][b:b + 1]))
                elif j in (2, 3):
                    name, p = ("coarse", d["coarse_p"]) if j == 2 else ("dropout", d["dropout_p"])
                    drop = (aug._channel_choice(per_c[:, j], d[name][b:b + 1])
                            < aug._per_image(p[b:b + 1])).to(x.dtype)
                    x = aug._coarse_dropout(x, drop) if j == 2 else aug._dropout(x, drop)
                else:
                    op = {4: aug._add, 5: aug._multiply, 6: aug._contrast}[j]
                    x = op(x, d["values"][j - 4][b:b + 1])
        out.append(x.clamp(0.0, 255.0))
    return torch.cat(out)


@pytest.mark.parametrize("iteration", [0, 3.2e6, 6.4e8])
def test_branch_free_augmentation_equals_the_per_op_composition(iteration):
    """Bit for bit in float32, given the same draws: the body runs every op
    on every image at each of the 7 positions and keeps each image's own;
    the reference applies each image's ops alone in its order. Each image
    takes each op at most once, at one position, and no more than one op a
    position; at a late iteration most images take several."""
    images = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (12, *HW, 3), dtype=np.uint8))
    d = aug.augment_draws(torch.Generator().manual_seed(7), images.shape, iteration, "cpu")
    assert d["select"].sum(dim=1).max() <= 1 and d["select"].sum(dim=0).max() <= 1
    got = aug.augment_body(images, d)
    assert torch.equal(got, _composed(images, d))
    assert torch.equal(got, aug.augment_batch(images, torch.Generator().manual_seed(7), iteration))
    if iteration == 6.4e8:
        assert (d["select"].sum(dim=(0, 1)) >= 2).sum() >= 6


def test_augment_draws_are_made_in_a_fixed_order():
    """The draws are a function of the generator's state alone, filled in
    place into given buffers as made fresh, and the noise and dropout
    fields come at full batch shape."""
    shape = (4, *HW, 3)
    a = aug.augment_draws(torch.Generator().manual_seed(3), shape, 1e6, "cpu")
    bufs = {k: torch.full_like(v, 7) for k, v in a.items()}
    b = aug.augment_draws(torch.Generator().manual_seed(3), shape, 1e6, "cpu", out=bufs)
    assert b is bufs and set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert a["noise"].shape == a["dropout"].shape == shape and a["coarse"].shape == (4, 4, 6, 3)
    assert a["select"].shape == (7, 7, 4) and a["values"].shape == (3, 4, 1, 1, 3)


def test_augment_program_on_the_cpu_is_the_eager_body():
    """The program's buffers hold the draws; on the CPU it runs the body on
    them: equal to ``augment_batch`` call after call, one key per shape."""
    program = aug.AugmentProgram("cpu")
    rng = np.random.default_rng(2)
    for it, n in ((0, 4), (1, 4), (2, 6)):
        images = torch.from_numpy(rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8))
        got = program(images, torch.Generator().manual_seed(it), 6.4e8)
        assert torch.equal(got, aug.augment_batch(images, torch.Generator().manual_seed(it), 6.4e8))
    assert len(program.programs) == 2 and program.key == ((6, *HW, 3), torch.uint8)



def test_read_pngs_equals_read_png_frame_by_frame(tmp_path, rng):
    """A batch decoded together (its Average and Paeth rows' anti-diagonals
    walked once for all frames) equals each frame read alone: frames of
    every row filter, of Sub rows only, grey and RGBA among them; frames of
    another size raise."""
    every = ([0, 1, 2, 3, 4] * 7)[:HW[0]]
    paths = []
    for i, (filt, channels) in enumerate([(every, 3), (1, 3), (4, 1), (every[::-1], 4), (2, 3)]):
        img = rng.integers(0, 256, (*HW, channels), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        write_png(paths[-1], img[..., 0] if channels == 1 else img, filt)
    got = read_pngs(paths)
    assert got.shape == (5, *HW, 3) and got.dtype == np.uint8
    for frame, path in zip(got, paths):
        np.testing.assert_array_equal(frame, read_png(path))
    np.testing.assert_array_equal(read_pngs(paths[1:2] + paths[4:])[1], read_png(paths[4]))
    write_png(str(tmp_path / "big.png"), rng.integers(0, 256, (HW[0] + 1, HW[1], 3), dtype=np.uint8), 4)
    with pytest.raises(ValueError, match="among"):
        read_pngs([paths[0], str(tmp_path / "big.png")])
