"""Port parity of DCN training on the CPU: the deformable im2col backward,
the varifocal loss, VFNet's ATSS anchors and loss, the loss and every
gradient of VFNet R50-mdconv and GFL R50-DCN against erd_tpu, the frozen
stages, and ``build_trainer`` + ``fit`` of both configs.

Inputs are made with numpy from seeds on a 1/64 grid, which float32 holds
exactly; the networks are ``tests/test_torch_dcn.py``'s (4 classes, 64x96,
float32, every ``conv_offset`` arranged on both sides so that samples are
fractional and reach off the map). Tolerances, each with its reason:
- the plain backward (through ``deform_conv2d``'s autograd) against
  ``jax.vjp`` of erd_tpu's ``deform_conv2d``: d x, d offset, d mask rtol
  1e-5 with atol 1e-6 * max|g|, d weight atol 1e-5 * max|g| (the scatter,
  the channel sums and the product's rows in another order);
- ``gradcheck`` of the autograd Function in float64: its own defaults;
- erd_tpu's gradient of a bf16 map against its float32 gradient rounded
  once: within one bf16 ulp of the largest entry;
- the varifocal loss and ``vfnet_loss`` from identical inputs: rtol 1e-5,
  their input gradients rtol 1e-5 with atol 1e-6 * max|g|; the boxes lie on
  a 1/4096 grid, where box edges do not meet the gt edges (where they meet,
  jax's and torch's max, min and clamp may split a gradient differently);
- the VFNet head from identical FPN maps, and the whole networks, both
  sides in float32: the loss dict rtol 1e-5, the gradients of all
  trainable parameters together within ||diff|| <= 1e-3 * ||g|| and of
  each tensor within 5e-3 * ||g|| + 1e-7 * (the largest ||g||), the
  limits of ``tests/test_torch_detr_train.py``: not element by element,
  because a float32 ReLU input within rounding of 0 may route its gradient
  either way. Unlike the DETR tests the port runs in float32 here: its
  float32 gradient lies much nearer erd_tpu's than its float64 one, which
  on VFNet misses the 1e-3 limit by erd_tpu's own float32 rounding. The
  frozen stem and layer1 take no gradient in the port
  (requires_grad=False); erd_tpu masks their updates in the optimizer
  instead.
The whole-network tests run erd_tpu's gradient compiled with XLA's backend
optimisation off (a third less compile time).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.engine.optim import _freeze_label_fn
from erd_tpu.losses.extra import varifocal_loss as j_varifocal_loss
from erd_tpu.models.heads.vfnet_head import VFNetContext as JVFNetContext
from erd_tpu.models.heads.vfnet_head import VFNetHeadNet as JVFNetHead
from erd_tpu.models.heads.vfnet_head import decode_levels as j_decode_levels
from erd_tpu.models.heads.vfnet_head import vfnet_loss as j_vfnet_loss
from erd_tpu.ops.deform_conv import _bilinear_zero
from erd_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, build_trainer
from erd_tpu_torch.config import Config
from erd_tpu_torch.engine import resnet_frozen_paths
from erd_tpu_torch.losses import varifocal_loss
from erd_tpu_torch.models import GFLDetector, VFNetDetector
from erd_tpu_torch.models.heads import (VFNetContext, VFNetHeadNet,
                                        decode_levels, vfnet_loss)
from erd_tpu_torch.models.weight_import import params_from_jax
from erd_tpu_torch.ops import (ModulatedDeformConv, arrange_offsets,
                               deform_conv2d, deform_im2col,
                               deform_im2col_backward,
                               deform_im2col_backward_plain)
from erd_tpu_torch.structures import GTInstances, ImageMeta, stack_to
from tests.test_torch_dcn import (GFL_DCN_CFG, IMAGE, NUM_CLASSES,
                                  VFNET_CFG, arranged, nchw, offsets_nchw,
                                  small_cfg, to_numpy)
from tests.test_torch_train import OneBatchLoader, Recorder

torch.set_num_threads(2)

MAX_GT = 4
IMG_IDS = (3, 5)
GTS = [([[10, 8, 60, 50], [30, 4, 90, 40], [40, 30, 94, 62]], [1, 3, 0]),
       ([[4, 6, 40, 44], [44, 20, 90, 60]], [2, 1])]


def grid(a, step=64):
    """``a`` rounded to multiples of 1 / step, float32 (exact)."""
    return (np.round(np.asarray(a) * step) / step).astype(np.float32)


def compile_fast(fn, *args):
    """``fn(*args)`` jitted with XLA's backend optimisation off."""
    return jax.jit(fn).lower(*args).compile(
        {'xla_backend_optimization_level': 0})(*args)


def assert_close(got, want, rtol=1e-5, atol_rel=1e-6, name=''):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=name)


def numpy_batch(gts=GTS):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 255, (len(gts),) + IMAGE + (3,), dtype=np.uint8)
    gt = [JGTInstances.pad(np.asarray(b, np.float32).reshape(-1, 4), lab,
                           MAX_GT) for b, lab in gts]
    meta = [JImageMeta.make(IMAGE, IMAGE, (1.0, 1.0), img_id=i)
            for i in IMG_IDS[:len(gts)]]
    return images, gt, meta


def jax_batch(gts=GTS):
    images, gt, meta = numpy_batch(gts)
    stack = lambda items: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.asarray(np.stack(xs)), *items)
    return dict(images=jnp.asarray(images), gt=stack(gt), meta=stack(meta))


def port_gt(gt):
    return stack_to([GTInstances(bboxes=g.bboxes, labels=g.labels,
                                 mask=g.mask) for g in gt], 'cpu')


def port_batch(gts=GTS):
    images, gt, _ = numpy_batch(gts)
    return dict(
        images=torch.from_numpy(images), gt=port_gt(gt),
        meta=stack_to([ImageMeta.make(IMAGE, IMAGE, (1.0, 1.0), img_id=i)
                       for i in IMG_IDS[:len(gts)]], 'cpu'))


# ------------------------------------------- the deformable im2col backward
def dcn_grad_case(rs, dg, stride, modulated, border, b=2, h=7, w=9, cin=6):
    """A map, offsets, masks, a weight and an output gradient on the 1/64
    grid, erd_tpu's layouts; with ``border`` a third of the samples land
    exactly on rows / columns -1, 0, H-1 and H."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = grid(rs.randn(b, h, w, cin))
    offset = grid(rs.randn(b, ho, wo, dg, 9, 2) * 2.0)
    if border:
        ky, kx = np.divmod(np.arange(9), 3)
        base_y = np.arange(ho)[:, None, None] * stride - 1 + ky
        base_x = np.arange(wo)[None, :, None] * stride - 1 + kx
        ty = rs.choice([-1, 0, h - 1, h], (b, ho, wo, dg, 9))
        tx = rs.choice([-1, 0, w - 1, w], (b, ho, wo, dg, 9))
        exact = np.stack([ty - base_y[:, :, None], tx - base_x[:, :, None]],
                         -1).astype(np.float32)
        pick = rs.rand(b, ho, wo, dg, 9, 1) < 0.35
        offset = np.where(pick, exact, offset)
    mask = grid(rs.rand(b, ho, wo, dg, 9)) if modulated else None
    weight = grid(rs.randn(3, 3, cin, 5) * 0.5)
    g = grid(rs.randn(b, ho, wo, 5))
    return x, offset.astype(np.float32), mask, weight, g


def sample_shares(offset, h, w, stride):
    """(fractional, with a corner off the map) shares of the samples of
    erd_tpu's (B, Ho, Wo, dg, 9, 2) offsets."""
    ho, wo = offset.shape[1:3]
    ky, kx = np.divmod(np.arange(9), 3)
    ys = (np.arange(ho)[:, None, None, None] * stride - 1 + ky) + \
        offset[..., 0]
    xs = (np.arange(wo)[None, :, None, None] * stride - 1 + kx) + \
        offset[..., 1]
    y0, x0 = np.floor(ys), np.floor(xs)
    frac = ((ys != y0) | (xs != x0)).mean()
    off = ((y0 < 0) | (y0 + 1 > h - 1) | (x0 < 0) | (x0 + 1 > w - 1)).mean()
    return frac, off


@pytest.mark.parametrize('dg,stride,modulated,border', [
    (1, 1, True, False), (2, 2, True, False), (1, 2, False, False),
    (2, 1, False, False), (1, 1, True, True), (2, 1, False, True)])
def test_deform_backward_plain_matches_jax_vjp(dg, stride, modulated,
                                               border):
    rs = np.random.RandomState(dg * 100 + stride * 10 + 2 * modulated +
                               border)
    x, offset, mask, weight, g = dcn_grad_case(rs, dg, stride, modulated,
                                               border)
    frac, off = sample_shares(offset, x.shape[1], x.shape[2], stride)
    assert frac >= 0.5 and off >= 0.01

    def fn(xx, oo, ww, mm=None):
        return jax.vmap(lambda a, o, m: j_deform_conv2d(
            a, o, ww, m, stride=stride, deform_groups=dg))(xx, oo, mm)
    primals = [jnp.asarray(v) for v in (x, offset, weight)]
    if modulated:
        primals.append(jnp.asarray(mask))
    _, vjp = jax.vjp(fn, *primals)
    want = jax.jit(vjp)(jnp.asarray(g))

    tx = nchw(x).requires_grad_()
    toff = offsets_nchw(offset).requires_grad_()
    tw = torch.from_numpy(weight).permute(3, 2, 0, 1).contiguous() \
        .requires_grad_()
    tm = nchw(mask.reshape(*mask.shape[:3], -1)).requires_grad_() \
        if modulated else None
    out = deform_conv2d(tx, toff, tw, tm, stride=stride, deform_groups=dg)
    out.backward(nchw(g))
    assert_close(tx.grad.permute(0, 2, 3, 1), want[0], name='x')
    assert_close(toff.grad.permute(0, 2, 3, 1).reshape(offset.shape),
                 want[1], name='offset')
    assert_close(tw.grad.permute(2, 3, 1, 0), want[2], atol_rel=1e-5,
                 name='weight')
    if modulated:
        assert_close(tm.grad.permute(0, 2, 3, 1).reshape(mask.shape),
                     want[3], name='mask')
    # the wrapper's CPU path is the plain version, bit for bit
    cols_g = torch.from_numpy(rs.randn(2, 6 * 9, out.shape[2] *
                                       out.shape[3]).astype(np.float32))
    args = (tx.detach(), toff.detach(), None if tm is None else tm.detach(),
            cols_g, 3, stride, 1, 1, dg)
    for a, b in zip(deform_im2col_backward(*args),
                    deform_im2col_backward_plain(*args)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize('modulated', [True, False])
def test_deform_im2col_function_passes_gradcheck(modulated):
    """Finite differences in float64 of the Function on the plain path, two
    deform groups, stride 2; the fractions kept 0.1 away from the integers,
    where the function has kinks."""
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.randn(2, 4, 5, 6)).requires_grad_()
    off = rs.randn(2, 36, 3, 3) * 1.5
    off = np.floor(off) + 0.1 + 0.8 * rs.rand(*off.shape)
    off = torch.from_numpy(off).requires_grad_()
    inputs = [x, off]
    if modulated:
        inputs.append(torch.from_numpy(rs.rand(2, 18, 3, 3))
                      .requires_grad_())
    assert torch.autograd.gradcheck(
        lambda *a: deform_im2col(a[0], a[1], a[2] if modulated else None,
                                 3, 2, 1, 1, 2), tuple(inputs))


def test_deform_im2col_computes_the_gradients_asked_for():
    """Autograd reaches only the inputs that need a gradient, with the
    backward's values; the CPU path counts no launch; under no_grad the
    columns carry no graph; bf16 maps take a bf16 gradient."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(grid(rs.randn(2, 8, 6, 7)))
    off = torch.from_numpy(grid(rs.randn(2, 18, 6, 7) * 1.5))
    m = torch.from_numpy(grid(rs.rand(2, 9, 6, 7)))
    g = torch.from_numpy(grid(rs.randn(2, 72, 42)))
    counts = (deform_im2col.launches, deform_im2col_backward.launches)
    with torch.no_grad():
        assert deform_im2col(x.requires_grad_(), off, m).grad_fn is None
    want = deform_im2col_backward_plain(x, off, m, g, 3, 1, 1, 1, 1)
    cols = deform_im2col(x, off, m)
    cols.backward(g)
    assert torch.equal(x.grad, want[0])
    x.requires_grad_(False)
    leaves = [off.clone().requires_grad_(), m.clone().requires_grad_()]
    deform_im2col(x, leaves[0], leaves[1]).backward(g)
    assert torch.equal(leaves[0].grad, want[1]) and \
        torch.equal(leaves[1].grad, want[2])
    only = deform_im2col_backward_plain(x, off, m, g, 3, 1, 1, 1, 1,
                                        need_x=False)
    assert only[0] is None and torch.equal(only[1], want[1])
    xb = x.bfloat16().requires_grad_()
    deform_im2col(xb, off, None).backward(g)
    assert xb.grad.dtype == torch.bfloat16 and torch.equal(
        xb.grad, deform_im2col_backward_plain(
            x, off, None, g, 3, 1, 1, 1, 1)[0].bfloat16())
    assert (deform_im2col.launches,
            deform_im2col_backward.launches) == counts
    with pytest.raises(ValueError, match='grad'):
        deform_im2col_backward(x, off, m, g[:, 1:])


def warp_combined_map_gradient(x, offset, mask, grad, k, stride, pad, dil,
                               dg):
    """The map gradient as the backward kernel adds it, in float64: the
    samples in its thread order ((image, group, kernel point, pixel), the
    pixel fastest) in warps of 32; a key per sample whose top-left corner
    can touch the map ((plane set counted from the warp's first lane, row,
    column) packed so that only a row's neighbours differ by 1), a distinct
    one otherwise; runs of neighbouring lanes with one key, their first
    lane (the head) adding the run's four sums; a head whose key is the
    previous head's plus 1 takes that run's right-hand sums into its
    left-hand adds, and the previous head leaves them out. Returns the map
    gradient and the atomic adds issued a channel."""
    from erd_tpu_torch.ops.deform_conv import _samples
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk, cpg = k * k, cin // dg
    y0, x0, wy, wx = (t.reshape(-1) for t in _samples(
        offset, k, stride, pad, dil, dg, torch.float64))
    y0, x0 = y0.tolist(), x0.tolist()
    m = torch.ones(len(y0), dtype=torch.float64) if mask is None else \
        mask.double().reshape(-1)
    total, n_set = len(y0), kk * ho * wo
    g = grad.double().reshape(b * dg, cpg, kk * ho * wo).permute(
        1, 0, 2).reshape(cpg, total)
    a = g * m
    corner = torch.stack([a * (1 - wx) * (1 - wy), a * wx * (1 - wy),
                          a * (1 - wx) * wy, a * wx * wy])  # tl tr bl br
    gx = torch.zeros(b * dg, cpg, h * w, dtype=torch.float64)
    adds = 0
    for w0 in range(0, total, 32):
        lanes = range(w0, min(total, w0 + 32))
        keys = []
        for t in lanes:
            touch = -1 <= y0[t] < h and -1 <= x0[t] < w
            rel = t // n_set - w0 // n_set
            keys.append(((rel * (h + 1) + y0[t] + 1) * (w + 2) + x0[t] + 1)
                        if touch else -2 - (t - w0))
        heads = [i for i in range(len(keys)) if i == 0 or
                 keys[i] != keys[i - 1]]
        for j, i in enumerate(heads):
            end = heads[j + 1] if j + 1 < len(heads) else len(keys)
            t = w0 + i
            sums = corner[:, :, w0 + i:w0 + end].sum(2)  # (4, cpg)
            merge = j > 0 and keys[i] >= 0 and keys[heads[j - 1]] == \
                keys[i] - 1
            consumed = j + 1 < len(heads) and keys[i] >= 0 and \
                keys[heads[j + 1]] == keys[i] + 1
            if merge:
                prev = heads[j - 1]
                psums = corner[:, :, w0 + prev:w0 + i].sum(2)
                sums[0] += psums[1]
                sums[2] += psums[3]
            for c, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                yy, xx = y0[t] + dy, x0[t] + dx
                if dx == 1 and consumed:
                    continue
                if 0 <= yy < h and 0 <= xx < w and keys[i] >= 0:
                    gx[t // n_set, :, yy * w + xx] += sums[c]
                    adds += 1
    return gx.reshape(b, cin, h, w), adds


@pytest.mark.parametrize('case', ['smooth', 'star', 'far', 'tiny',
                                  'stride2_groups'])
def test_deform_backward_warp_combining_adds_up(case):
    """The backward kernel's combining of a warp's map-gradient adds (runs
    of lanes on one corner, heads taking their run's sums, a run's right
    corners handed to the next run), emulated in plain float64: its map
    gradient equals ``deform_im2col_backward_plain``'s, and it issues no
    more adds than the samples' on-map corners, half of them where
    neighbouring samples move alike (smooth: a per-point bias, the path's
    arranged conv_offset). Star offsets (7 px out, +- 0.6 px of jitter:
    coinciding corners, runs, gaps), offsets of 30 px, a 2 x 3 map (a warp
    spans plane sets), stride 2 with 2 deform groups."""
    rs = np.random.RandomState(7)
    b, cin, h, w = 2, 4, 14, 30
    stride, dg = (2, 2) if case == 'stride2_groups' else (1, 1)
    if case == 'tiny':
        h, w = 2, 3
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if case == 'star':
        ky, kx = np.divmod(np.arange(9), 3)
        star = np.stack([ky - 1, kx - 1], -1) * 7.0
        off = star[None, None, :, :, None, None] + rs.normal(
            0, 0.6, (b, dg, 9, 2, ho, wo))
    elif case in ('smooth', 'stride2_groups'):
        off = rs.normal(0, 1.5, (1, dg, 9, 2, 1, 1)) + rs.normal(
            0, 0.05, (b, dg, 9, 2, ho, wo))
    else:
        off = rs.randn(b, dg, 9, 2, ho, wo) * (30.0 if case == 'far' else 3)
    x = torch.from_numpy(rs.randn(b, cin, h, w))
    offset = torch.from_numpy(off.reshape(b, dg * 18, ho, wo))
    mask = torch.from_numpy(rs.rand(b, dg * 9, ho, wo))
    g = torch.from_numpy(rs.randn(b, cin * 9, ho * wo))
    geo = (3, stride, 1, 1, dg)
    got, adds = warp_combined_map_gradient(x, offset, mask, g, *geo)
    want = deform_im2col_backward_plain(x, offset, mask, g, *geo)[0]
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    from erd_tpu_torch.ops.deform_conv import _corner, _samples
    y0, x0, _, _ = _samples(offset, 3, stride, 1, 1, dg, torch.float64)
    on = sum(int(_corner(torch.zeros(b, dg, 1, h * w), h, w, y0 + dy,
                         x0 + dx)[2].sum())
             for dy in (0, 1) for dx in (0, 1))
    assert adds <= on
    if case == 'smooth':
        assert adds <= 0.6 * on


# the deformable im2col backward calls of one bs-16, 800x1344 step of GFL
# R101-DCN (DCNv1 in stages 2-4) and VFNet R50-mdconv (DCNv2 in stages 2-4,
# the head's star convs on P3-P7): (Cin, H, W, stride, calls a step)
DCN_STEP_CALLS = {
    'gfl_r101_dcn': [(512, 25, 42, 1, 2), (512, 50, 84, 2, 1),
                     (256, 50, 84, 1, 22), (256, 100, 168, 2, 1),
                     (128, 100, 168, 1, 3), (128, 200, 336, 2, 1)],
    'vfnet_r50_mdconv': [(256, 7, 11, 1, 2), (256, 13, 21, 1, 2),
                         (256, 25, 42, 1, 2), (256, 50, 84, 1, 2),
                         (256, 100, 168, 1, 2), (512, 25, 42, 1, 2),
                         (512, 50, 84, 2, 1), (256, 50, 84, 1, 5),
                         (256, 100, 168, 2, 1), (128, 100, 168, 1, 3),
                         (128, 200, 336, 2, 1)]}


@pytest.mark.parametrize('kind', sorted(DCN_STEP_CALLS))
def test_deform_backward_chunk_fits_every_call_of_a_step(kind):
    """The backward kernel's plan for each call shape of a bs-16 step:
    the group's channels in one chunk where the samples fill the card
    ONE_CHUNK_BLOCKS times over (the VFNet head's P3 and P4, stages 2 and
    3), else chunks of SPLIT_CHUNK (stage 4 and its stride-2 entry, the
    head's P5-P7); 132 blocks or more in all."""
    from erd_tpu_torch.ops.deform_conv import (
        BACKWARD_THREADS, ONE_CHUNK_BLOCKS, SPLIT_CHUNK,
        deform_backward_chunk)
    assert sum(n for *_, n in DCN_STEP_CALLS[kind]) == \
        {'gfl_r101_dcn': 30, 'vfnet_r50_mdconv': 23}[kind]
    for cin, h, w, stride, _ in DCN_STEP_CALLS[kind]:
        ho, wo = -(-h // stride), -(-w // stride)
        chunk = deform_backward_chunk(16, cin, 1, 3, ho, wo)
        samples = -(-16 * 9 * ho * wo // BACKWARD_THREADS)
        one = samples >= ONE_CHUNK_BLOCKS * 132
        assert chunk == (cin if one else SPLIT_CHUNK), (cin, h, w, stride)
        assert one == (ho * wo >= 50 * 84), (cin, h, w, stride)
        blocks = samples * (1 if one else 1 + cin // chunk)
        assert blocks >= 132
    # two deform groups: a group's channels are what is split
    assert deform_backward_chunk(16, 512, 2, 3, 25, 42) == 64
    assert deform_backward_chunk(16, 512, 2, 3, 50, 84) == 256
    assert deform_backward_chunk(16, 96, 2, 3, 25, 42) == 48


def test_jax_rounds_a_bf16_maps_gradient_in_bf16():
    """Why a bf16 map's gradient is held against the plain version (on the
    card), not against erd_tpu: JAX transposes the gather of a bf16 map
    (the VFNet head's star convs) into a bf16 scatter-add, so erd_tpu
    rounds partial sums to bf16, while the port sums in float32 and rounds
    once. The two differ in some entries, by at most one bf16 ulp of the
    largest entry here."""
    rs = np.random.RandomState(0)
    h, w = 6, 7
    img = jnp.asarray(rs.randn(h, w, 3), jnp.bfloat16)
    ys = jnp.asarray(grid(rs.uniform(-1, h, 40)))
    xs = jnp.asarray(grid(rs.uniform(-1, w, 40)))
    g = jnp.asarray(grid(rs.randn(40, 3)))
    grads = [jax.vjp(lambda im: _bilinear_zero(im, ys, xs), m)[1](g)[0]
             for m in (img, img.astype(jnp.float32))]
    assert grads[0].dtype == jnp.bfloat16
    got = np.asarray(grads[0].astype(jnp.float32))
    once = np.asarray(grads[1].astype(jnp.bfloat16).astype(jnp.float32))
    assert (got != once).any()
    assert np.abs(got - once).max() <= 2 ** -7 * np.abs(once).max()


# ------------------------------------------------------------------ losses
def test_varifocal_loss_matches_jax():
    """IoU-weighted and not, with element weights and avg_factor, and the
    'none' reduction; input gradients."""
    rs = np.random.RandomState(4)
    pred = grid(rs.randn(40, 6) * 3)
    target = np.where(rs.rand(40, 6) > 0.8, grid(rs.rand(40, 6)), 0.0) \
        .astype(np.float32)
    weight = grid(rs.rand(40, 6))
    for kw in (dict(), dict(iou_weighted=False, reduction='sum'),
               dict(weight=weight, avg_factor=7.0), dict(reduction='none')):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        want, jgrad = jax.value_and_grad(
            lambda p: j_varifocal_loss(p, jnp.asarray(target), **jkw).sum())(
            jnp.asarray(pred))
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        p = torch.from_numpy(pred).requires_grad_()
        got = varifocal_loss(p, torch.from_numpy(target), **tkw).sum()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        got.backward()
        assert_close(p.grad, jgrad, name=str(kw))


def test_vfnet_context_matches_jax():
    for canvas in (IMAGE, (800, 1344)):
        want, got = JVFNetContext.build(canvas), VFNetContext.build(canvas)
        assert got.num_level_points == tuple(want.num_level_points)
        for name in ('points', 'strides', 'anchors'):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    ctx = VFNetContext.build(IMAGE)
    assert ctx.device_anchors('cpu') is ctx.device_anchors('cpu')


def loss_case(rs, ctx, gts):
    """Logits on the 1/64 grid; initial and refined boxes decoded from
    distances on the 1/4096 grid at the context's points."""
    b, n = len(gts), ctx.points.shape[0]
    cls = grid(rs.randn(b, n, NUM_CLASSES) * 2)
    dist = [grid(rs.uniform(4, 40, (b, n, 4)), 4096) for _ in range(2)]
    pts = ctx.points[None]
    return [cls] + [np.concatenate([pts - d[..., :2], pts + d[..., 2:]], -1)
                    .astype(np.float32) for d in dist]


@pytest.mark.parametrize('gts', [GTS, [GTS[0], ([], [])]],
                         ids=['gt', 'empty_image'])
def test_vfnet_loss_matches_jax(gts):
    """The loss dict and its gradients in the logits and both boxes; with
    an image without gt (only its negatives count), and a batch whose only
    image without gt has loss_bbox = loss_bbox_rf = 0."""
    rs = np.random.RandomState(5)
    ctx, jctx = VFNetContext.build(IMAGE), JVFNetContext.build(IMAGE)
    arrays = loss_case(rs, ctx, gts)
    _, gt, _ = numpy_batch(gts)
    jgt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *gt)

    def jtotal(c, bi, br):
        parts = j_vfnet_loss(jctx, c, bi, br, jgt, NUM_CLASSES)
        return sum(parts.values()), parts
    (_, parts), jgrads = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1, 2), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = vfnet_loss(ctx, *leaves, port_gt(gt), NUM_CLASSES)
    assert set(got) == set(parts) == {'loss_cls', 'loss_bbox',
                                      'loss_bbox_rf'}
    for k in parts:
        np.testing.assert_allclose(got[k].item(), float(parts[k]),
                                   rtol=1e-5, err_msg=k)
        assert got[k].item() > 0, k
    sum(got.values()).backward()
    for name, leaf, w in zip(('cls', 'ini', 'ref'), leaves, jgrads):
        assert_close(leaf.grad, w, name=name)
    if len(gts[1][0]) == 0:  # the image without gt: no box loss
        none = vfnet_loss(ctx, *[t[1:] for t in leaves],
                          port_gt(gt[1:]), NUM_CLASSES)
        assert none['loss_bbox'].item() == 0.0 == \
            none['loss_bbox_rf'].item() and none['loss_cls'].item() > 0
        assert leaves[1].grad[1].abs().max() == 0


# ------------------------------------------------------------- gradients
def assert_grads(named, want):
    """The trainable parameters' .grad against ``want`` (a
    state-dict-shaped map): all together within ||diff|| <= 1e-3 * ||g||,
    each within 5e-3 * ||g|| + 1e-7 * the largest ||g||; frozen ones have
    none. Returns the names checked."""
    frozen = resnet_frozen_paths(1)
    named = list(named)
    scale = max(float(want[n].norm()) for n, p in named if p.requires_grad)
    checked, total, total_err = [], 0.0, 0.0
    for name, p in named:
        if name.startswith(frozen):
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name].numpy()
        err = float(np.linalg.norm(p.grad.numpy() - w))
        assert err <= 5e-3 * np.linalg.norm(w) + 1e-7 * scale, \
            (name, err, float(np.linalg.norm(w)))
        total += float(np.sum(w.astype(np.float64) ** 2))
        total_err += err ** 2
        checked.append(name)
    assert total_err ** 0.5 <= 1e-3 * total ** 0.5
    return checked


def test_vfnet_head_grads_match_jax():
    """From identical FPN maps: the loss and every head parameter's
    gradient, and the part of vfnet_reg's gradient that reaches it only
    through the star offsets' 0.1 (loss_cls + loss_bbox_rf: the refined
    boxes take the initial ones detached)."""
    rs = np.random.RandomState(8)
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    feats = [grid(rs.randn(2, h, w, 32)) for h, w in sizes]
    jhead = JVFNetHead(num_classes=NUM_CLASSES, feat_channels=32)
    variables = to_numpy(jax.jit(jhead.init)(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))
    params = variables['params']
    jctx, ctx = JVFNetContext.build(IMAGE), VFNetContext.build(IMAGE)
    _, gt, _ = numpy_batch()
    jgt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *gt)
    keys = (('loss_cls', 'loss_bbox', 'loss_bbox_rf'),
            ('loss_cls', 'loss_bbox_rf'))

    def jloss(p, names):
        cls, ini, ref = jhead.apply({'params': p},
                                    [jnp.asarray(f) for f in feats])
        flat = lambda ls, c: jnp.concatenate(  # noqa: E731
            [m.reshape(2, -1, c) for m in ls], 1)
        parts = j_vfnet_loss(jctx, flat(cls, NUM_CLASSES),
                             flat(j_decode_levels(jctx, ini), 4),
                             flat(j_decode_levels(jctx, ref), 4), jgt,
                             NUM_CLASSES)
        return sum(parts[k] for k in names), parts
    net = VFNetHeadNet(NUM_CLASSES, 32)
    state = params_from_jax({'params': {'bbox_head': params}})
    net.load_state_dict({k[len('bbox_head.'):]: v for k, v in state.items()},
                        strict=True)
    for names in keys:
        (_, parts), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, names), has_aux=True))(params)
        want = {k[len('bbox_head.'):]: v for k, v in params_from_jax(
            to_numpy({'params': {'bbox_head': grads}})).items()}
        net.zero_grad()
        cls, ini, ref = net([nchw(f) for f in feats])
        flat = lambda ls, c: torch.cat(  # noqa: E731
            [m.reshape(2, -1, c) for m in ls], 1)
        got = vfnet_loss(ctx, flat(cls, NUM_CLASSES),
                         flat(decode_levels(ctx, ini), 4),
                         flat(decode_levels(ctx, ref), 4), port_gt(gt),
                         NUM_CLASSES)
        for k in parts:
            np.testing.assert_allclose(got[k].item(), float(parts[k]),
                                       rtol=1e-5, err_msg=k)
        sum(got[k] for k in names).backward()
        checked = assert_grads(net.named_parameters(), want)
        assert len(checked) == len(list(net.parameters()))
        assert float(want['vfnet_reg.weight'].norm()) > 0, names


# ------------------------------------------------------ the whole networks
def jax_train_run(path, seed):
    """erd_tpu's detector of the config (4 classes, float32, conv_offset
    arranged), its variables, and its loss and gradients on the batch."""
    from erd_tpu.apis.build import build_detector as j_build_detector
    from erd_tpu.config import Config as JConfig
    jdet = j_build_detector(small_cfg(JConfig, path).model)
    variables = arranged(to_numpy(jdet.init(jax.random.PRNGKey(seed),
                                            image_shape=IMAGE)), seed + 3)
    consts = {k: v for k, v in variables.items() if k != 'params'}
    batch = jax_batch()

    def total(params):
        losses = jdet.loss({'params': params, **consts}, batch)
        return sum(losses.values()), losses
    (_, losses), grads = compile_fast(
        jax.value_and_grad(total, has_aux=True), variables['params'])
    return dict(variables=variables,
                losses={k: float(v) for k, v in losses.items()},
                grads=params_from_jax(to_numpy({'params': grads})))


@pytest.fixture(scope='module')
def vfnet_run():
    return jax_train_run(VFNET_CFG, 1)


@pytest.fixture(scope='module')
def gfl_run():
    return jax_train_run(GFL_DCN_CFG, 0)


@pytest.mark.parametrize('kind', ['vfnet', 'gfl'])
def test_whole_network_loss_and_grads_match_jax(kind, request):
    run = request.getfixturevalue(f'{kind}_run')
    det = build_detector(small_cfg(Config, VFNET_CFG if kind == 'vfnet'
                                   else GFL_DCN_CFG).model)
    assert isinstance(det, VFNetDetector if kind == 'vfnet' else
                      GFLDetector) and det.frozen_stages == 1
    net = det.build_net()
    net.load_state_dict(params_from_jax(run['variables']), strict=True)
    losses = det.loss(net, port_batch())
    assert set(losses) == set(run['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-5,
                                   err_msg=k)
    sum(losses.values()).backward()
    checked = assert_grads(net.named_parameters(), run['grads'])
    assert len(checked) == sum(1 for p in net.parameters()
                               if p.requires_grad)
    offsets = [n for n in checked if '.conv_offset.' in n]
    assert len(offsets) == 2 * 13  # C3-C5 of ResNet-50: 4 + 6 + 3 blocks
    assert all(float(net.get_parameter(n).grad.abs().max()) > 0
               for n in offsets)


def test_vfnet_freezes_the_paths_erd_tpu_freezes(vfnet_run):
    """The port's VFNet (built from the config) has requires_grad False on
    exactly the parameters that erd_tpu's trainer masks
    (``resnet_frozen_paths(1)``: the stem and layer1)."""
    params = vfnet_run['variables']['params']
    labels = _freeze_label_fn(1)(params)
    marks = jax.tree.map(lambda lab, p: np.full(
        np.shape(p), lab == 'frozen', np.float32), labels, params)
    consts = {k: jax.tree.map(np.zeros_like, v) for k, v in
              vfnet_run['variables'].items() if k != 'params'}
    state = params_from_jax({'params': marks, **consts})
    det = build_detector(small_cfg(Config, VFNET_CFG).model)
    net = det.build_net()
    named = dict(net.named_parameters())
    want = {k for k, v in state.items() if k in named and bool(v.all())}
    got = {k for k, p in named.items() if not p.requires_grad}
    assert got == want and len(got) > 0
    assert all(k.startswith(('backbone.conv1.', 'backbone.bn1.',
                             'backbone.layer1.')) for k in got)


@pytest.mark.parametrize('path', [VFNET_CFG, GFL_DCN_CFG],
                         ids=['vfnet', 'gfl'])
def test_fit_two_steps_from_the_dcn_configs(path):
    """build_trainer + fit of the config (ResNet-50, DCN in C3-C5, 4
    classes, float32) for two steps on the CPU: finite losses, the frozen
    stem and layer1 unchanged, every trainable weight moved, each
    conv_offset included."""
    cfg = small_cfg(Config, path)
    cfg.train_cfg.epochs = 1
    cfg.optim.update(lr=0.01, warmup_factor=1.0)
    det = build_detector(cfg.model)
    net = det.init(seed=3, device='cpu')
    arrange_offsets(net, seed=5)
    start = copy.deepcopy(net.state_dict())
    rec = Recorder()
    trainer = build_trainer(cfg, det, OneBatchLoader(port_batch(), 2),
                            device='cpu')
    trainer.hooks.append(rec)
    trainer.fit(net)
    assert rec.calls[-1] == 'after_epoch 0' and len(rec.losses) == 2
    for losses in rec.losses:
        assert all(np.isfinite(v) for v in losses.values()), losses
    frozen = resnet_frozen_paths(1)
    trainable = {n for n, p in net.named_parameters() if p.requires_grad}
    assert trainable and not any(n.startswith(frozen) for n in trainable)
    offsets = [n for n in trainable if '.conv_offset.weight' in n]
    assert len(offsets) == 13
    for name, value in net.state_dict().items():
        moved = not torch.equal(value, start[name])
        assert not (name.startswith(frozen) and moved), name
        if name in trainable and value.dim() > 1:
            assert moved, name
    assert any(isinstance(m, ModulatedDeformConv) for m in net.modules())
