"""Generate the "dress" data set: procedural image/caption pairs as webdataset tars.

The counterpart of ``scripts/make_dress_dataset.py``, with its own copy of
the renderer (numpy and Pillow only). Each sample is a scene with a
natural-image-like 1/f spectrum (multi-scale noise backgrounds) and a
colored object whose shape, color and backdrop the caption names (12 x 8 x
6 = 576 classes, four caption templates), JPEG-encoded at ``--quality`` and
packed by the port's ``data/pipeline.py::write_tar_shards`` into the shard
layout ``TarShardSource`` reads. Contrastive training and the retrieval
validator have real signal on a held-out shard.

Deterministic per (seed, index): a sample is bit for bit the JAX script's,
and the shards' members are its members, byte for byte (for one Pillow).
``--workers N`` renders in N processes; the bytes do not change.

Usage:
  python scripts/torch_make_dress_dataset.py --out dress --n 100000 --workers 8
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

COLORS = {
    "red": (200, 40, 40), "green": (40, 170, 60), "blue": (40, 80, 200),
    "yellow": (220, 200, 40), "purple": (140, 60, 180), "orange": (230, 130, 30),
    "white": (235, 235, 235), "black": (25, 25, 25), "pink": (240, 130, 180),
    "brown": (130, 85, 45), "teal": (40, 160, 160), "gray": (128, 128, 128),
}
SHAPES = ["circle", "square", "triangle", "ring", "stripe", "diamond", "cross", "dot"]
BACKDROPS = {
    "grassy": (60, 130, 60), "sandy": (200, 175, 120), "cloudy": (180, 190, 205),
    "rocky": (120, 115, 110), "ocean": (40, 90, 150), "sunset": (210, 120, 70),
}
TEMPLATES = [
    "a photo of a {c} {s} on a {b} background.",
    "a {c} {s} against a {b} backdrop.",
    "an image showing a {c} {s} in a {b} scene.",
    "the {c} {s}, photographed on {b} terrain.",
]


class _Banks:
    """Precomputed texture and noise fields, built once per (seed, size):
    each sample composes a bank entry with random dihedral flips instead of
    synthesising full-resolution noise, deterministic per (seed, index)."""

    def __init__(self, seed, size, k=48):
        from PIL import Image

        rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBA2C5]))
        self.tex = []
        for _ in range(k):
            acc = np.zeros((size, size, 3), np.float32)
            for res, w in ((8, 0.55), (32, 0.3), (128, 0.15)):
                layer = rng.normal(0.0, 1.0, (res, res, 3)).astype(np.float32)
                img = Image.fromarray(
                    ((layer - layer.min()) / (np.ptp(layer) + 1e-6) * 255).astype(np.uint8))
                acc += w * np.asarray(img.resize((size, size), Image.BILINEAR), np.float32)
            # 1/f-ish multi-octave texture in [-0.5, 0.5]
            self.tex.append(np.ascontiguousarray(acc / 255.0 - 0.5))
        self.noise = [rng.normal(0, 4.0, (size, size, 3)).astype(np.float32) for _ in range(8)]
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        self.yy, self.xx = yy, xx
        d = ((xx / size - 0.5) ** 2 + (yy / size - 0.5) ** 2)[..., None]
        self.vignette = (1.0 - 0.35 * d).astype(np.float32)


_BANKS = {}


def _flip(a, rng):
    sy, sx = (1, -1)[rng.integers(2)], (1, -1)[rng.integers(2)]
    return a[::sy, ::sx]


def _shape_mask(shape, banks, cx, cy, r, rng):
    dx, dy = banks.xx - cx, banks.yy - cy
    if shape == "circle":
        return dx * dx + dy * dy < r * r
    if shape == "dot":
        return dx * dx + dy * dy < (r * 0.4) ** 2
    if shape == "ring":
        d2 = dx * dx + dy * dy
        return (d2 < r * r) & (d2 > (0.55 * r) ** 2)
    if shape == "square":
        return (np.abs(dx) < r) & (np.abs(dy) < r)
    if shape == "diamond":
        return np.abs(dx) + np.abs(dy) < 1.2 * r
    if shape == "triangle":
        return (dy > -r) & (dy + 2 * np.abs(dx) < r)
    if shape == "cross":
        return ((np.abs(dx) < 0.33 * r) & (np.abs(dy) < r)) | (
            (np.abs(dy) < 0.33 * r) & (np.abs(dx) < r))
    if shape == "stripe":
        ang = rng.uniform(0, np.pi)
        return np.abs(dx * np.sin(ang) - dy * np.cos(ang)) < 0.3 * r
    raise ValueError(shape)


def render_sample(seed, index, size=256, color=None, shape=None, backdrop=None):
    """One deterministic (HWC uint8 image, caption) pair. Passing
    color / shape / backdrop forces the class; the rng draws the three
    class indices all the same, in this order, so forced and free renders
    share the rest of the noise stream."""
    banks = _BANKS.get((seed, size))
    if banks is None:
        banks = _BANKS[(seed, size)] = _Banks(seed, size)
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    c_i = rng.integers(len(COLORS))  # always drawn, so forcing a class
    s_i = rng.integers(len(SHAPES))  # doesn't shift the downstream stream
    b_i = rng.integers(len(BACKDROPS))
    color = color or list(COLORS)[c_i]
    shape = shape or SHAPES[s_i]
    backdrop = backdrop or list(BACKDROPS)[b_i]
    tex = _flip(banks.tex[rng.integers(len(banks.tex))], rng)
    base = np.asarray(BACKDROPS[backdrop], np.float32)
    img = base * (1.0 + 0.9 * tex)
    cx, cy = rng.uniform(0.3, 0.7, 2) * size
    r = rng.uniform(0.12, 0.28) * size
    mask = _shape_mask(shape, banks, cx, cy, r, rng)
    fg = np.asarray(COLORS[color], np.float32) * rng.uniform(0.85, 1.15)
    img[mask] = np.clip(0.85 * fg + 0.15 * img[mask], 0, 255)
    # photographic touches: vignette + sensor noise
    img *= banks.vignette
    img += _flip(banks.noise[rng.integers(len(banks.noise))], rng)
    caption = TEMPLATES[rng.integers(len(TEMPLATES))].format(c=color, s=shape, b=backdrop)
    return np.clip(img, 0, 255).astype(np.uint8), caption


def _render(job):
    seed, index, size = job
    return render_sample(seed, index, size)


def samples(seed, n, size, pool=None, log_every=2000):
    """render_sample(seed, i, size) for i < n, in order; through ``pool``'s
    processes when one is given."""
    jobs = ((seed, i, size) for i in range(n))
    rendered = pool.imap(_render, jobs, chunksize=32) if pool is not None else map(_render, jobs)
    for i, sample in enumerate(rendered):
        if i % log_every == 0:
            print(f"[make_dress_dataset] {i}/{n}", flush=True)
        yield sample


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples-per-shard", type=int, default=10_000)
    p.add_argument("--quality", type=int, default=90)
    p.add_argument("--workers", type=int, default=1, help="render processes (the bytes do not depend on it)")
    args = p.parse_args(argv)

    pool = None
    if args.workers > 1:
        import multiprocessing

        pool = multiprocessing.get_context("spawn").Pool(args.workers)
    from clip_mixer_tpu_torch.data.pipeline import write_tar_shards

    try:
        paths = write_tar_shards(samples(args.seed, args.n, args.size, pool), args.out, args.samples_per_shard,
                                 quality=args.quality)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    print(f"[make_dress_dataset] wrote {len(paths)} shards to {args.out}")
    return paths


if __name__ == "__main__":
    main()
