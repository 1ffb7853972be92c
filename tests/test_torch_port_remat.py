"""Tower rematerialisation (``CLIPConfig.remat``) in the port, on the CPU.

Each ``remat_policy`` must give the gradients of the model without remat (f32,
to 1e-6), and must save for backward what it says: the products it keeps
in the forward are the ones it names, the tensors kept for backward are
ordered none < mlp_hidden < all_hidden < no remat, and the backward
recomputes every other product of the block. With ``fused_mlp`` the channel
mix is the ``ln_mlp`` kernel, whose forward still runs once a block a step.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from clip_mixer_tpu_torch import config as tcfg
from clip_mixer_tpu_torch.models import mixer
from clip_mixer_tpu_torch.models.clip import CLIP
from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
from clip_mixer_tpu_torch.ops.losses import info_nce

SMALL = tcfg.CLIPConfig(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
                        context_length=12, vocab_size=256, text_width=64, text_heads=1, text_layers=2,
                        compute_dtype="float32")
POLICIES = ("none", "mlp_hidden", "all_hidden")
GRAD_TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(B=6, seed=0):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(0, 1, (B, 32, 32, 3)).astype(np.float32))
    texts = torch.from_numpy(rng.integers(1, 250, (B, 12)).astype(np.int64))
    texts[:, 6] = 255  # eot, the argmax id
    return images, texts


def _loss(model, images, texts):
    img, txt, scale, _ = model.forward_train(images, texts)
    return info_nce(img, txt, scale, grad_through_gather=True)


def _grads(cfg, images, texts):
    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    loss = _loss(model, images, texts)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("fused_mlp", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_equal_no_remat(policy, fused_mlp):
    images, texts = _inputs()
    base = SMALL.replace(fused_mlp=fused_mlp)
    want_loss, want = _grads(base, images, texts)
    got_loss, got = _grads(base.replace(remat=True, remat_policy=policy), images, texts)
    assert got_loss == want_loss  # the same forward, bit for bit
    for name, g in got.items():
        torch.testing.assert_close(g, want[name], msg=name, **GRAD_TOL)


class _CountProducts(TorchDispatchMode):
    """Counts the products (``mm``, ``bmm``) dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
        return func(*args, **(kwargs or {}))


def _kept_and_recomputed(cfg, images, texts, monkeypatch):
    """(the tensors the forward saved for backward where
    ``saved_tensors_hooks`` see them, that is outside the checkpointed
    blocks; the products the remat policy kept in the blocks; the products
    the backward ran: its own and any recomputed)."""
    kept, saved = [0], [0]
    keep_tagged = mixer._keep_tagged

    def counting(names):
        policy = keep_tagged(names)

        def counted(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            kept[0] += not ctx.is_recompute and decision == CheckpointPolicy.MUST_SAVE
            return decision

        return counted

    monkeypatch.setattr(mixer, "_keep_tagged", counting)
    def pack(t):
        saved[0] += 1
        return t

    model = CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = _loss(model, images, texts)
    with _CountProducts() as backward:
        loss.backward()
    return saved[0], kept[0], backward.n


def test_each_policy_saves_what_it_says(monkeypatch):
    """Each policy keeps its tagged products (one a block for mlp_hidden,
    two for all_hidden), so the tensors kept for backward (saved, plus
    kept) are ordered none < mlp_hidden < all_hidden < off; and the
    backward recomputes every product but those: the backward's products
    are ordered off < all_hidden < mlp_hidden < none, one block's kept
    product apart."""
    images, texts = _inputs()
    blocks = SMALL.vision_layers + SMALL.text_layers
    saved, kept, ran = {}, {}, {}
    for p in POLICIES:
        cfg = SMALL.replace(remat=True, remat_policy=p)
        saved[p], kept[p], ran[p] = _kept_and_recomputed(cfg, images, texts, monkeypatch)
    saved["off"], kept["off"], ran["off"] = _kept_and_recomputed(SMALL, images, texts, monkeypatch)
    assert kept == {"none": 0, "mlp_hidden": blocks, "all_hidden": 2 * blocks, "off": 0}, kept
    assert saved["none"] == saved["mlp_hidden"] == saved["all_hidden"], saved  # outside the blocks
    total = {p: saved[p] + kept[p] for p in saved}
    assert total["none"] < total["mlp_hidden"] < total["all_hidden"] < total["off"], total
    assert ran["off"] < ran["all_hidden"] < ran["mlp_hidden"] < ran["none"], ran
    # a block's forward makes four products; full remat reruns the first
    # three: the last one's inputs are all its backward needs, and the
    # recompute stops once it has them
    assert ran["none"] - ran["off"] == 3 * blocks, ran
    assert ran["none"] - ran["mlp_hidden"] == blocks, ran
    assert ran["mlp_hidden"] - ran["all_hidden"] == blocks, ran


def test_fused_mlp_remat_runs_the_kernel_forward_once(monkeypatch):
    """Under remat the ln_mlp kernel keeps only its inputs, and its backward
    needs only those, so the backward's recompute of a block records the
    call without running it: one launch a block a step on the card, as
    without remat (``chip_smoke.py`` expects that). Counted here through
    the CPU tensors' plain version, which the wrapper takes where the card
    launches the kernel; under every policy."""
    calls = [0]
    plain = kln.ln_mlp_plain

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(kln, "ln_mlp_plain", counted)
    images, texts = _inputs()
    blocks = SMALL.vision_layers + SMALL.text_layers
    for remat, policy in ((False, "none"), *((True, p) for p in POLICIES)):
        calls[0] = 0
        cfg = SMALL.replace(fused_mlp=True, remat=remat, remat_policy=policy)
        _loss(CLIP(cfg, device="cpu"), images, texts).backward()
        assert calls[0] == blocks, (remat, policy, calls[0])
    calls[0] = 0
    with torch.no_grad():  # no autograd, no remat: one forward a block
        _loss(CLIP(SMALL.replace(fused_mlp=True, remat=True), device="cpu"), images, texts)
    assert calls[0] == blocks


def test_remat_refuses_only_the_multi_device_fields():
    CLIP(SMALL.replace(remat=True, remat_policy="all_hidden"), device="cpu")
    # model_axis (parallel/tp.py) and pipeline_axis (parallel/pp.py) are
    # ported: a config carries them, the groups live on the model
    CLIP(SMALL.replace(remat=True, model_axis="x"), device="cpu")
    assert CLIP(SMALL.replace(remat=True, pipeline_axis="x"), device="cpu").cfg.pipeline_axis == "x"
