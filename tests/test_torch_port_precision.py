"""float64 through the port on the CPU (`mtp_tpu_torch/ops/precision.py`):
the plain versions of the kernels and the layers that compute in fp32 by
design keep float64, so that a float64 copy of a model evaluates the same
function as the fp32 one, in float64 — the reference that
`tools/strip_gradient_witness.py` holds the card's and the CPU's fp32
gradients to.  No kernel takes float64: the wrappers refuse it anywhere but
on the CPU, and refuse mixed precisions.  Inputs are made with numpy from a
seed."""

from unittest import mock

import numpy as np
import pytest
import torch

from mtp_tpu_torch.ckpt.from_jax import init_weights
from mtp_tpu_torch.config import BackboneConfig, TaskConfig, TrainConfig
from mtp_tpu_torch.heads.rpn import gen_proposals
from mtp_tpu_torch.models.detector import DetConfig, TwoStageDetector
from mtp_tpu_torch.models.segmentor import Segmentor
from mtp_tpu_torch.ops import dcnv3_sample as dcn
from mtp_tpu_torch.ops import fused_attn
from mtp_tpu_torch.ops.precision import NoDowncast, at_least_fp32
from mtp_tpu_torch.tasks import detection as det_core
from mtp_tpu_torch.tasks.detection_task import DetectionTask
from mtp_tpu_torch.tasks.segmentation import SegmentationTask

torch.set_num_threads(1)

HW = (2080, 112)  # the strip of chip_smoke.py phase 14: grid 130×7, N = 910
CFG = BackboneConfig(img_size=2080, embed_dim=32, depth=2, num_heads=2,
                     interval=2, out_indices=(0, 1, 1, 1), dtype="float32",
                     remat=True, drop_path_rate=0.1)


def _np(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _attention64(q, k, v, bias, scale):
    """softmax(q·kᵀ·scale + bias)·v in numpy float64."""
    s = np.einsum("whqd,whkd->whqk", q, k) * scale + bias
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("whqk,whkd->whqd", p / p.sum(-1, keepdims=True), v)


def test_at_least_fp32():
    x = torch.ones(3, dtype=torch.bfloat16)
    assert at_least_fp32(x).dtype == torch.float32
    y = torch.ones(3)
    assert at_least_fp32(y) is y
    z = torch.ones(3, dtype=torch.float64)
    assert at_least_fp32(z) is z


@pytest.mark.parametrize("N", [25, 600])  # K1/K4's plain versions; K1L/K7's
def test_window_attention_computes_in_float64(N):
    """Forward to 1e-12 of numpy's float64 (fp32 would be ~1e-7 off), and
    float64 gradients that match the fp32 ones to fp32 rounding."""
    W, nH, D, scale = 1, 2, 8, 8 ** -0.5
    arrays = [_np((W, nH, N, D), s) for s in range(3)] + [_np((W, nH, N, N), 3, 0.5)]
    want = _attention64(*arrays, scale)
    cot = _np((W, nH, N, D), 4)
    grads = {}
    for dtype in (torch.float64, torch.float32):
        q, k, v, bias = (torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays)
        with NoDowncast() if dtype == torch.float64 else torch.enable_grad():
            out = fused_attn.fused_window_attention(q, k, v, bias, scale)
            (out * torch.tensor(cot, dtype=dtype)).sum().backward()
        assert out.dtype == dtype and all(t.grad.dtype == dtype for t in (q, k, v, bias))
        if dtype == torch.float64:
            np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-12, rtol=0)
        grads[dtype] = [t.grad.double() for t in (q, k, v, bias)]
    for g64, g32 in zip(grads[torch.float64], grads[torch.float32]):
        assert float((g32 - g64).norm()) <= 1e-5 * float(g64.norm())


def test_flash_attention_and_sampling_compute_in_float64():
    """K2/K5's and K3/K6's plain versions: float64 in, float64 out, within
    fp32 rounding of the fp32 run."""
    BH, grid, D = 2, (5, 6), 8
    N = grid[0] * grid[1]
    arrays = [_np((BH, N, D), s) for s in range(3)]
    arrays += [_np((BH, N, grid[0]), 3, 0.5), _np((BH, N, grid[1]), 4, 0.5)]
    rng = np.random.default_rng(5)
    img, coords = _np((3, 4 * 5, 6), 6), rng.uniform(-1.5, 5.5, (3, 3, 7, 2))
    results = {}
    for dtype in (torch.float64, torch.float32):
        q, k, v, rh, rw = (torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays)
        x = torch.tensor(img, dtype=dtype, requires_grad=True)
        py, px = (torch.tensor(coords[..., i], dtype=dtype, requires_grad=True)
                  for i in range(2))
        m = torch.ones_like(py, requires_grad=True)
        with NoDowncast() if dtype == torch.float64 else torch.enable_grad():
            outs = (fused_attn.flash_full_attention(q, k, v, rh, rw, grid, 0.3),
                    dcn.dcnv3_sample(x, py, px, m, 4, 5))
            sum(o.square().sum() for o in outs).backward()
        leaves = (q, k, v, rh, rw, x, py, px, m)
        assert all(o.dtype == dtype for o in outs)
        assert all(t.grad.dtype == dtype for t in leaves)
        results[dtype] = [t.detach().double() for t in outs] + [t.grad.double() for t in leaves]
    for r64, r32 in zip(results[torch.float64], results[torch.float32]):
        assert float((r32 - r64).norm()) <= 1e-5 * float(r64.norm())


def test_wrappers_refuse_float64_off_the_cpu_and_mixed():
    q = torch.zeros(1, 2, 25, 8, dtype=torch.float64)
    bias = torch.zeros(1, 2, 25, 25, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_attn.fused_window_attention(q.to("meta"), q.to("meta"), q.to("meta"),
                                          bias.to("meta"), 1.0)
    with pytest.raises(TypeError, match="bias"):  # float64 q, fp32 bias
        fused_attn.fused_window_attention(q, q, q, bias.float(), 1.0)
    img = torch.zeros(2, 12, 4, dtype=torch.float64)
    coord = torch.zeros(2, 6, 1, dtype=torch.float64)
    with pytest.raises(TypeError, match="py"):
        dcn.dcnv3_sample(img, coord.float(), coord, coord, 3, 4)
    with pytest.raises(TypeError, match="img"):
        dcn.dcnv3_sample(img.to("meta"), coord.to("meta"), coord.to("meta"),
                         coord.to("meta"), 3, 4)


def test_float64_witness_of_a_strip_train_step():
    """A toy Segmentor at phase 14's strip (the full blocks on K1L/K7's
    plain versions, remat, dropout and drop-path on): its float64 copy runs
    the task's loss and backward with no op rounding float64 (forward,
    remat's recompute and the autograd Functions' backward), and the fp32
    gradients lie within fp32 rounding of it."""
    task_cfg = TaskConfig(task="segmentation", num_classes=3, backbone=CFG,
                          train=TrainConfig(batch_size=1))
    model = init_weights(Segmentor(CFG, 3, channels=16, input_hw=HW),
                         torch.Generator().manual_seed(0))
    image = torch.from_numpy(_np((1,) + HW + (3,), 7).astype(np.float32))
    label = torch.from_numpy(np.random.default_rng(8).integers(0, 3, (1,) + HW))
    runs = {}
    for dtype in (torch.float32, torch.float64):
        m = model if dtype == torch.float32 else \
            init_weights(Segmentor(CFG, 3, channels=16, input_hw=HW),
                         torch.Generator().manual_seed(0)).double()
        task = SegmentationTask(task_cfg, model=m, device="cpu")
        batch = {"image": image.to(dtype), "label": label}
        mode = NoDowncast()
        with mode if dtype == torch.float64 else torch.enable_grad():
            loss, _ = task.loss_fn(m, batch, torch.Generator().manual_seed(9))
            loss.backward()
        if dtype == torch.float64:
            assert mode.backward_calls > 0  # the backward ran under it
        runs[dtype] = loss.item(), {n: p.grad for n, p in m.named_parameters()}
    (l32, g32), (l64, g64) = runs[torch.float32], runs[torch.float64]
    assert all(g.dtype == torch.float64 for g in g64.values())
    assert abs(l32 - l64) <= 1e-5 * abs(l64)
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in g64.values())))
    for name, g in g64.items():
        diff = float((g32[name].double() - g).norm())
        assert diff <= 1e-3 * float(g.norm()) + 1e-6 * g_all, name


def test_float64_witness_of_a_detection_loss():
    """A toy Faster R-CNN (ViT+RVSA, random sampling regressors) on fixed
    proposals, as `tools/strip_gradient_witness.py --path det_vit` runs
    phase 19's: its float64 copy runs the detection loss and backward with
    no op rounding float64 (the RPN and box head's fp32 layers, the
    targets, RoIAlign, the losses), and the fp32 gradients lie within fp32
    rounding of it."""
    hw = (64, 96)
    bb = BackboneConfig(img_size=64, embed_dim=32, depth=2, num_heads=2, interval=2,
                        out_indices=(0, 0, 1, 1), dtype="float32", drop_path_rate=0.0)
    det = dict(nms_pre=128, max_proposals=32, rpn_num=32, rcnn_num=16, max_per_img=8,
               max_gts=4)
    cfg = TaskConfig(task="detection", num_classes=3, backbone=bb,
                     train=TrainConfig(batch_size=2))
    make = lambda: init_weights(TwoStageDetector(bb, DetConfig(num_classes=3, **det),
                                                 input_hw=hw),
                                torch.Generator().manual_seed(0))
    model = make()
    assert any(p.abs().sum() > 0 for n, p in model.named_parameters()
               if ".attn.sampling_" in n)
    rng = np.random.default_rng(5)
    xy = rng.uniform(4, 40, (2, 4, 2))
    batch = {"image": torch.from_numpy(_np((2,) + hw + (3,), 6).astype(np.float32)),
             "gt_boxes": torch.from_numpy(np.concatenate(
                 [xy, xy + rng.uniform(12, 40, (2, 4, 2))], -1).astype(np.float32)),
             "gt_labels": torch.from_numpy(rng.integers(0, 3, (2, 4))),
             "gt_valid": torch.tensor([[True, True, True, False]] * 2)}
    task = DetectionTask(cfg, det_overrides=det, model=model, device="cpu")
    with torch.no_grad():
        props = gen_proposals(model.rpn(model.features(batch["image"])),
                              task.anchors_on(hw, "cpu"), hw, 128, 32, 0.7,
                              level_sizes=det_core.anchor_level_sizes(hw))
    fixed = lambda *a, **k: props
    runs = {}
    for dtype in (torch.float32, torch.float64):
        m = model if dtype == torch.float32 else make().double()
        task = DetectionTask(cfg, det_overrides=det, model=m, device="cpu")
        b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
        mode = NoDowncast()
        with mock.patch.object(det_core, "gen_proposals", fixed), \
                mode if dtype == torch.float64 else torch.enable_grad():
            loss, _ = task.loss_fn(m, b, torch.Generator().manual_seed(9),
                                   deterministic=True)
            loss.backward()
        if dtype == torch.float64:
            assert mode.backward_calls > 0  # the backward ran under it
        runs[dtype] = loss.item(), {n: p.grad for n, p in m.named_parameters()
                                    if p.grad is not None}
    (l32, g32), (l64, g64) = runs[torch.float32], runs[torch.float64]
    assert g64.keys() == g32.keys() and len(g64) > 50
    assert all(g.dtype == torch.float64 for g in g64.values())
    assert abs(l32 - l64) <= 1e-5 * abs(l64)
    g_all = float(torch.sqrt(sum((g ** 2).sum() for g in g64.values())))
    for name, g in g64.items():
        diff = float((g32[name].double() - g).norm())
        assert diff <= 1e-3 * float(g.norm()) + 1e-6 * g_all, name


def test_no_downcast_catches_a_rounded_float64():
    with pytest.raises(TypeError, match="float64"):
        with NoDowncast():
            torch.ones(2, dtype=torch.float64).float()
    with NoDowncast() as mode:  # fp32 alone, and float64 kept, pass
        torch.ones(2).sum()
        (torch.ones(2, dtype=torch.float64) * torch.ones(2)).sum()
    assert mode.calls >= 4
