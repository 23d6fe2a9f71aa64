"""The inputs of a run, made from its seed: camera frames, target points,
the planner's starting noise, the training set's waypoints, and the PNG
files and waypoint files of a training set on disk.

Each kind of input draws from its own stream, ``np.random.SeedSequence((
seed, tag))``, so adding one never moves another. Frames are drawn on the
device (a smooth random field plus noise, as camera frames have both) and
copied to the host once.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

__all__ = ["stream_seed", "frames", "targets", "init_trajs", "waypoints", "write_dataset", "write_png"]

TAGS = {"weights": 1, "frames": 2, "targets": 3, "init": 4, "waypoints": 5, "loader": 6, "augment": 7,
        "step": 8, "check": 9}


def stream_seed(seed: int, tag: str, *more: int) -> int:
    """A 63-bit seed for the stream ``tag`` (and ``more``, e.g. an
    iteration) of run seed ``seed``."""
    return int(np.random.SeedSequence([int(seed), TAGS[tag], *more]).generate_state(1, np.uint64)[0] >> 1)


def frames(seed: int, n: int, height: int, width: int, device) -> np.ndarray:
    """``n`` uint8 RGB frames (n, height, width, 3) on the host."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "frames"))
    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, :, None]
    out = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    phases = torch.rand((n, 3), generator=g, device=device) * (2 * np.pi)
    for i in range(n):
        base = 127.0 + 100.0 * torch.sin(xx / 37.0 + yy / 23.0 + phases[i])
        noise = torch.randn((height, width, 3), generator=g, device=device) * 20.0
        out[i] = (base + noise).clamp(0, 255).to(torch.uint8)
    return out.cpu().numpy()


def targets(seed: int, n: int) -> np.ndarray:
    """(n, 2) float32 ego-frame target points, uniform in [-1, 1]^2."""
    return np.random.default_rng(stream_seed(seed, "targets")).uniform(-1, 1, (n, 2)).astype(np.float32)


def init_trajs(seed: int, shape) -> torch.Tensor:
    """The planner's starting noise, standard normal, on the CPU."""
    return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(stream_seed(seed, "init")))


def waypoints(seed: int, n: int, horizon: int, dim: int):
    """(targets (n, 2) in [-1, 1], transitions (n, horizon, dim) in
    [-1.2, 1.2], which the dataset clips to [-1, 1]), rounded to the six
    decimals the waypoint files hold."""
    rng = np.random.default_rng(stream_seed(seed, "waypoints"))
    return (np.round(rng.uniform(-1, 1, (n, 2)), 6), np.round(rng.uniform(-1.2, 1.2, (n, horizon, dim)), 6))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row with filter Sub, in stored (level 0)
    deflate blocks: quick to write, and the decoder still undoes every
    row's filter."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]  # modulo 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 0)) + chunk(b"IEND", b""))


def write_dataset(root: str, images: np.ndarray, target: np.ndarray, trajs: np.ndarray) -> None:
    """The dataset layout the training loader reads: ``front/{i:06d}.png``
    and ``waypoints/{i:06d}.txt`` (the target, then one transition a line)."""
    for sub in ("front", "waypoints"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, img in enumerate(images):
        write_png(os.path.join(root, "front", f"{i:06d}.png"), img)
        lines = [" ".join(f"{v:.6f}" for v in target[i])] + [" ".join(f"{v:.6f}" for v in row) for row in trajs[i]]
        with open(os.path.join(root, "waypoints", f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
