"""Port parity: erd_tpu_torch's Deformable DETR and DINO serving path vs
erd_tpu on the CPU.

Each detector is erd_tpu's at ``tests/test_dino.py``'s size (ResNet-18, 4
classes, 20 queries, 64x96 images), its weights carried into the port by
``params_from_jax``, with the sampling weights arranged on both sides by
``arrange_sampling`` (erd_tpu's zero init would put every sample on a cell
centre with uniform attention). Inputs are made with numpy from a seed.
Tolerances, each with its reason:
- the sampling (plain version), 1e-6 * max|v|: the same float32 ops; the
  points may be summed in another order (it agrees to 0.0 here);
- LayerNorm, attention, the neck and the layers in float32, 1e-5 * max|out|
  (products summed in another order, exp / rsqrt differ by an ulp);
- the heads on identical float32 maps: float32 1e-5 * max|out|; bf16 (the
  bf16-rounded weights, and decoder_0's bf16 ops where erd_tpu has them)
  2e-2 * max|out| for Deformable DETR, measured at 9.3e-3 (its decoder_0
  self-attention, norm1 and sampling projections run in bf16, and a bf16
  rounding that differs by an ulp moves what follows), and 1e-5 for DINO,
  measured at 8.8e-7 (only decoder_0's value projection is bf16);
- predict in float32: the top-k query indices and labels exactly, scores
  1e-5, boxes 1e-2 px; the network 1e-4 * max|out|.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.detectors.deformable_detr import \
    DeformableDETRDetector as JDeformableDETR
from erd_tpu.models.detectors.dino import DINODetector as JDINO
from erd_tpu.models.heads.deformable_detr_head import \
    DeformableDecoderLayer as JDecoderLayer
from erd_tpu.models.heads.deformable_detr_head import \
    DeformableDETRHeadNet as JDeformableDETRHead
from erd_tpu.models.heads.deformable_detr_head import \
    DeformableEncoderLayer as JEncoderLayer
from erd_tpu.models.heads.detr_head import cxcywh_to_xyxy as j_to_xyxy
from erd_tpu.models.heads.detr_head import xyxy_to_cxcywh as j_to_cxcywh
from erd_tpu.models.heads.dino_head import DINODecoderLayer as JDINODecoder
from erd_tpu.models.heads.dino_head import DINOHeadNet as JDINOHead
from erd_tpu.models.heads.dino_head import \
    sine_embed_boxes as j_sine_embed_boxes
from erd_tpu.models.layers import cast_compute_params
from erd_tpu.models.necks.extra_necks import ChannelMapper as JChannelMapper
from erd_tpu.ops.ms_deform_attn import \
    make_level_start_index as j_level_start
from erd_tpu.ops.ms_deform_attn import ms_deform_attn_sample
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, inference_detector
from erd_tpu_torch.config import Config
from erd_tpu_torch.models import DeformableDETRDetector, DINODetector
from erd_tpu_torch.models.heads import MSDeformAttn, arrange_sampling
from erd_tpu_torch.models.heads.deformable_detr_head import (
    DeformableDecoderLayer, DeformableEncoderLayer, level_grids)
from erd_tpu_torch.models.heads.dino_head import sine_embed_boxes
from erd_tpu_torch.models.layers import LayerNorm, MultiheadAttention
from erd_tpu_torch.models.necks import ChannelMapper
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                params_from_jax)
from erd_tpu_torch.ops import (make_level_start_index, ms_deform_attn,
                               ms_deform_attn_plain)
from erd_tpu_torch.ops.misc import topk_stable
from erd_tpu_torch.structures import (GTInstances, ImageMeta,
                                      cxcywh_to_xyxy, stack_to,
                                      xyxy_to_cxcywh)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {'deformable_detr': 'configs/deformable_detr/'
                              'deformable_detr_r50_50e_coco.py',
           'dino': 'configs/dino/dino-4scale_r50_12e_coco.py'}
NUM_CLASSES, NUM_QUERIES, CANVAS, C = 4, 20, (64, 96), 256
# the four levels of a 64x96 canvas: strides 8, 16, 32 and the extra 64
SHAPES = [(8, 12), (4, 6), (2, 3), (1, 2)]
# bf16 head tolerances (x max|out|), measured at 9.3e-3 and 8.8e-7
BF16_TOL = {'deformable_detr': 2e-2, 'dino': 1e-5}


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def port_state(tree, path):
    """The port's tensors of the erd_tpu sub-tree placed at ``path`` under
    a DETR head's params, mapped by ``params_from_jax``."""
    params = {'bbox_head': {'level_embed_0': np.zeros(C, np.float32)}}
    node = params
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = tree
    prefix = '.'.join(path) + '.'
    return {k[len(prefix):]: v
            for k, v in params_from_jax({'params': params}).items()
            if k.startswith(prefix)}


def arrange_both(module, jparams, seed=0):
    """arrange_sampling on the port's module, and the same weights into
    erd_tpu's params tree (module paths are erd_tpu's scopes)."""
    arrange_sampling(module, seed)
    for name, m in module.named_modules():
        if isinstance(m, MSDeformAttn):
            node = jparams
            for part in name.split('.') if name else []:
                node = node[part]
            for lin in ('sampling_offsets', 'attention_weights'):
                layer = getattr(m, lin)
                node[lin] = {
                    'kernel': layer.weight.detach().numpy().T.copy(),
                    'bias': layer.bias.detach().numpy().copy()}


def level_maps(rs, b=2):
    """Random float32 maps of the four levels: erd_tpu's NHWC list and the
    port's NCHW list."""
    maps = [rs.randn(b, h, w, C).astype(np.float32) for h, w in SHAPES]
    return maps, [torch.from_numpy(np.ascontiguousarray(
        m.transpose(0, 3, 1, 2))) for m in maps]


def flat_tokens(maps):
    return torch.from_numpy(np.concatenate(
        [m.reshape(m.shape[0], -1, C) for m in maps], 1))


def _build(kind):
    """erd_tpu's detector and variables, and the port's with the same
    weights (the sampling weights arranged on both)."""
    jcls, cls = ((JDINO, DINODetector) if kind == 'dino' else
                 (JDeformableDETR, DeformableDETRDetector))
    jdet = jcls(num_classes=NUM_CLASSES, depth=18, num_queries=NUM_QUERIES)
    kw = dict(max_gt=6) if kind == 'dino' else {}
    variables = to_numpy(jdet.init(jax.random.PRNGKey(0), image_shape=CANVAS,
                                   **kw))
    det = cls(num_classes=NUM_CLASSES, depth=18, num_queries=NUM_QUERIES)
    net = det.init(seed=0, device='cpu')
    arrange_both(net.bbox_head, variables['params']['bbox_head'])
    net.load_state_dict(params_from_jax(variables), strict=True)
    return dict(jdet=jdet, variables=variables, det=det, net=net)


@pytest.fixture(scope='module')
def models():
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _build(kind)
        return cache[kind]
    return get


# ------------------------------------------------------------- sampling
@pytest.mark.parametrize('case', ['inside', 'outside', 'centres',
                                  'one_level'])
def test_ms_deform_attn_plain_matches_jax(case):
    """Random locations inside [0, 1], reaching outside it (corners off
    the map read 0), exactly on cell centres (erd_tpu's zero init: bilinear
    weights 0 or 1), and a single level."""
    rs = np.random.RandomState(len(case))
    shapes = SHAPES[:1] if case == 'one_level' else SHAPES
    b, q, heads, hd, k = 2, 37, 8, 32, 4
    n = sum(h * w for h, w in shapes)
    vals = rs.randn(b, n, heads, hd).astype(np.float32)
    lv = len(shapes)
    lo, hi = (0.0, 1.0) if case != 'outside' else (-0.4, 1.4)
    loc = rs.uniform(lo, hi, (b, q, heads, lv, k, 2)).astype(np.float32)
    if case == 'centres':
        for i, (h, w) in enumerate(shapes):
            loc[:, :, :, i, :, 0] = (rs.randint(0, w, loc.shape[:3] + (k,))
                                     + 0.5) / w
            loc[:, :, :, i, :, 1] = (rs.randint(0, h, loc.shape[:3] + (k,))
                                     + 0.5) / h
    w8 = rs.rand(b, q, heads, lv * k).astype(np.float32)
    weights = (w8 / w8.sum(-1, keepdims=True)).reshape(b, q, heads, lv, k)
    starts = j_level_start(shapes)
    np.testing.assert_array_equal(make_level_start_index(shapes), starts)
    want = np.stack([np.asarray(ms_deform_attn_sample(
        [jnp.asarray(vals[i, starts[j]:starts[j + 1]].reshape(
            h, w, heads, hd)) for j, (h, w) in enumerate(shapes)],
        jnp.asarray(loc[i]), jnp.asarray(weights[i]))) for i in range(b)])
    args = (torch.from_numpy(vals), shapes, torch.from_numpy(loc),
            torch.from_numpy(weights))
    got = ms_deform_attn_plain(*args)
    close(got, want, 1e-6)
    assert torch.equal(ms_deform_attn(*args), got)  # CPU: the plain version
    # bf16 weights are widened exactly
    wb = torch.from_numpy(weights).bfloat16()
    assert torch.equal(ms_deform_attn(*args[:3], wb),
                       ms_deform_attn_plain(*args[:3], wb.float()))
    if case == 'outside':
        xs = loc[..., 0] * np.asarray([w for _, w in shapes])[:, None] - 0.5
        assert (xs < 0).mean() > 0.1  # corners really leave the map
    with pytest.raises(ValueError, match='cover'):
        ms_deform_attn(args[0][:, 1:], shapes, *args[2:])


# --------------------------------------------------------------- layers
def _flax_apply(module, *inputs, dtype=None, **kw):
    params = to_numpy(module.init(jax.random.PRNGKey(1), *inputs, **kw))
    run = cast_compute_params(params, dtype) if dtype is not None else params
    return params, jax.jit(lambda p, *x: module.apply(p, *x, **kw))(
        run, *inputs)


@pytest.mark.parametrize('layer,dtype', [
    ('layernorm', 'float32'), ('layernorm', 'bfloat16'),
    ('attention', 'float32'), ('attention_mask', 'float32'),
    ('attention', 'bfloat16'), ('channel_mapper', 'float32'),
    ('channel_mapper', 'bfloat16')])
def test_layer_matches_flax(layer, dtype):
    """flax's LayerNorm (epsilon 1e-6, fast variance, a mean of 3 so that
    the variance formula matters), MultiHeadDotProductAttention with and
    without a mask, and ChannelMapper (GN epsilon 1e-6, the extra level on
    the raw C5), against the port's, in float32 and with bf16 inputs and
    parameters. bf16 tolerances: 1e-2 * max|out| (bf16's ulp is 8e-3)."""
    import flax.linen as fnn
    rs = np.random.RandomState(2)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == 'float32' else 1e-2
    if layer == 'layernorm':
        x = (rs.randn(3, 7, C) * 2 + 3).astype(np.float32)
        params = {'params': {
            'scale': rs.uniform(0.5, 1.5, C).astype(np.float32),
            'bias': rs.randn(C).astype(np.float32)}}
        want = fnn.LayerNorm().apply(cast_compute_params(params, jdtype),
                                     jnp.asarray(x, jdtype))
        mod = LayerNorm(C, param_dtype=tdtype)
        mod.load_state_dict(port_state(params['params'],
                                       ('bbox_head', 'norm')))
        got = mod(torch.from_numpy(x).to(tdtype))
    elif layer.startswith('attention'):
        q = rs.randn(2, 11, C).astype(np.float32)
        kv = rs.randn(2, 13, C).astype(np.float32)
        mask = None
        if layer == 'attention_mask':
            mask = rs.rand(1, 1, 11, 13) > 0.4
            mask[..., 0] = True
        mha = fnn.MultiHeadDotProductAttention(num_heads=8)
        inputs = [jnp.asarray(a, jdtype) for a in (q, kv, kv)]
        params, want = _flax_apply(
            mha, *inputs, dtype=jdtype,
            mask=None if mask is None else jnp.asarray(mask))
        mod = MultiheadAttention(C, 8, param_dtype=tdtype)
        mod.load_state_dict(port_state(params['params'],
                                       ('bbox_head', 'self_attn')))
        got = mod(*(torch.from_numpy(a).to(tdtype) for a in (q, kv, kv)),
                  None if mask is None else torch.from_numpy(mask))
    else:
        in_ch = (32, 64, 128)
        xs = [rs.randn(2, h, w, c).astype(np.float32) for (h, w), c in
              zip([(16, 24), (8, 12), (4, 6)], in_ch)]
        cm = JChannelMapper(in_channels=in_ch, out_channels=64,
                            kernel_size=1, num_outs=4)
        params, want = _flax_apply(cm, [jnp.asarray(x, jdtype) for x in xs],
                                   dtype=jdtype)
        mod = ChannelMapper(in_ch, 64, kernel_size=1, num_outs=4)
        state = {k[len('neck.'):]: v for k, v in params_from_jax({
            'params': {'neck': params['params'], 'bbox_head': {
                'level_embed_0': np.zeros(C, np.float32)}}}).items()
            if k.startswith('neck.')}
        mod.load_state_dict(state, strict=True)
        got = mod([torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))).to(tdtype) for x in xs])
        assert len(got) == 4 and tuple(got[3].shape[2:]) == (2, 3)
        for g, w in zip(got, want):
            assert g.dtype == tdtype and w.dtype == jdtype
            close(g.permute(0, 2, 3, 1), w.astype(jnp.float32), tol)
        return
    assert got.dtype == tdtype and want.dtype == jdtype
    close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize('layer', ['encoder', 'deformable_detr_decoder',
                                   'dino_decoder'])
def test_deformable_layer_matches_jax(layer):
    """One encoder layer (both heads share it), one Deformable DETR decoder
    layer and one DINO decoder layer, float32, arranged sampling weights:
    the tokens of the four levels, per-token reference points and level
    positions; or 11 queries with reference points / boxes."""
    rs = np.random.RandomState(3)
    maps, _ = level_maps(rs)
    mem = flat_tokens(maps)
    if layer == 'encoder':
        refs = level_grids(SHAPES)[0][None].repeat(2, 0)
        pos = rs.randn(2, mem.shape[1], C).astype(np.float32)
        jmod = JEncoderLayer(C)
        args = (jnp.asarray(mem.numpy()), [jnp.asarray(m) for m in maps],
                jnp.asarray(refs), jnp.asarray(pos))
        mod = DeformableEncoderLayer(C)
        targs = (mem, SHAPES, torch.from_numpy(refs), torch.from_numpy(pos))
    else:
        query = rs.randn(2, 11, C).astype(np.float32)
        qpos = rs.randn(2, 11, C).astype(np.float32)
        box = layer == 'dino_decoder'
        ref = rs.uniform(0.1, 0.9, (2, 11, 4 if box else 2))
        ref = ref.astype(np.float32)
        if box:
            ref[..., 2:] *= 0.5
            jmod = JDINODecoder(C)
            mod = DeformableDecoderLayer(C, ffn_dim=2048, box=True)
        else:
            jmod = JDecoderLayer(C)
            mod = DeformableDecoderLayer(C)
        args = (jnp.asarray(query), jnp.asarray(qpos),
                [jnp.asarray(m) for m in maps], jnp.asarray(ref))
        if box:
            args = args + (None,)
        targs = (torch.from_numpy(query), torch.from_numpy(qpos), mem,
                 SHAPES, torch.from_numpy(ref))
    params = to_numpy(jmod.init(jax.random.PRNGKey(2), *args))
    arrange_both(mod, params['params'])
    mod.load_state_dict(port_state(params['params'], ('bbox_head', 'lyr')),
                        strict=True)
    want = jax.jit(jmod.apply)(params, *args)
    with torch.no_grad():
        got = mod(*targs)
    close(got, want, 1e-5)


def test_box_helpers_and_sine_embed_match_jax():
    rs = np.random.RandomState(4)
    boxes = rs.uniform(0, 1, (3, 17, 4)).astype(np.float32)
    t = torch.from_numpy(boxes)
    np.testing.assert_array_equal(cxcywh_to_xyxy(t).numpy(),
                                  np.asarray(j_to_xyxy(jnp.asarray(boxes))))
    np.testing.assert_array_equal(xyxy_to_cxcywh(t).numpy(),
                                  np.asarray(j_to_cxcywh(jnp.asarray(boxes))))
    want = np.asarray(j_sine_embed_boxes(jnp.asarray(boxes), 128))
    got = sine_embed_boxes(t, 128)
    assert got.shape == (3, 17, 384)
    close(got, want, 1e-5)


# ---------------------------------------------------------------- heads
@pytest.mark.parametrize('kind', list(CONFIGS))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_head_matches_jax(models, kind, dtype):
    """The whole head (encoder, DINO's query selection, decoder) on
    identical float32 maps, with the weights of the compute dtype; every
    decoder layer's outputs, and DINO's selected encoder outputs."""
    m = models(kind)
    jdtype = getattr(jnp, dtype)
    rs = np.random.RandomState(5)
    maps, tmaps = level_maps(rs)
    jhead = (JDINOHead if kind == 'dino' else JDeformableDETRHead)(
        num_classes=NUM_CLASSES, num_queries=NUM_QUERIES)
    jparams = cast_compute_params(
        {'params': m['variables']['params']['bbox_head']}, jdtype)
    want = jax.jit(jhead.apply)(jparams, [jnp.asarray(x) for x in maps])
    det = type(m['det'])(num_classes=NUM_CLASSES, depth=18,
                         num_queries=NUM_QUERIES,
                         compute_dtype=getattr(torch, dtype))
    net = det.build_net()
    net.load_state_dict(m['net'].state_dict())
    with torch.no_grad():
        got = net.bbox_head(tmaps)
    if kind == 'dino':
        keys = ('all_cls', 'all_boxes', 'enc_cls', 'enc_boxes')
        got, want = [got[k] for k in keys], [want[k] for k in keys]
    tol = 1e-5 if dtype == 'float32' else BF16_TOL[kind]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g, w, tol)


def metas():
    """Two images in the 64x96 canvas: one rescaled by 0.5 and smaller
    than the canvas (its boxes clip at 40x60), one at scale 1."""
    pairs = [((40, 60), (80, 120), (0.5, 0.5)),
             ((64, 96), (64, 96), (1.0, 1.0))]
    j = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                     *[JImageMeta.make(*p) for p in pairs])
    return j, stack_to([ImageMeta.make(*p) for p in pairs], 'cpu')


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_predict_matches_jax(models, kind, monkeypatch):
    """The float32 network against erd_tpu's (1e-4 * max|out|); predict's
    top-k query indices and labels exactly, scores 1e-5, boxes 1e-2 px
    (erd_tpu's predict is its post-processing on its own network outputs);
    then the port's inference_detector on images at the canvas size."""
    m = models(kind)
    jdet, variables, det, net = m['jdet'], m['variables'], m['det'], m['net']
    images = np.random.RandomState(6).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    outs = jdet.forward_jit(variables, jnp.asarray(images))
    mine = det.forward_raw(net, torch.from_numpy(images))
    if kind == 'dino':
        outs = (outs['all_cls'], outs['all_boxes'])
        mine = (mine['all_cls'], mine['all_boxes'])
    for g, w in zip(mine, outs):
        close(g, w, 1e-4)
    monkeypatch.setattr(jdet, 'forward_raw',
                        lambda v, x: dict(all_cls=outs[0],
                                          all_boxes=outs[1])
                        if kind == 'dino' else outs)
    jmeta, meta = metas()
    want = jax.jit(jdet.predict)(variables, dict(images=jnp.asarray(images),
                                                 meta=jmeta))
    got = det.predict(net, dict(images=torch.from_numpy(images), meta=meta))
    k = min(det.max_per_img, NUM_QUERIES * NUM_CLASSES)
    assert got.scores.shape == (2, k)
    jidx = np.asarray(jax.lax.top_k(jax.nn.sigmoid(outs[0][-1]).reshape(
        2, -1), k)[1]) // NUM_CLASSES
    tidx = topk_stable(torch.sigmoid(mine[0][-1]).reshape(2, -1),
                       k)[1] // NUM_CLASSES
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=0, atol=1e-2)
    assert (got.bboxes[0] <= torch.tensor([120.0, 80.0] * 2)).all()
    assert (got.bboxes[0, :, 2:] == torch.tensor([120.0, 80.0])).any()
    # the user's entry point on the same canvas (no resize, no rescale)
    res = inference_detector(det, net, list(images), scale=CANVAS[::-1])
    want_one = jax.jit(jdet.predict)(variables, dict(
        images=jnp.asarray(images), meta=jax.tree.map(
            lambda *xs: jnp.asarray(np.stack(xs)),
            *[JImageMeta.make(CANVAS, CANVAS, (1.0, 1.0))] * 2)))
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r.labels,
                                      np.asarray(want_one.labels[i]))
        np.testing.assert_allclose(r.scores, np.asarray(want_one.scores[i]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(r.bboxes, np.asarray(want_one.bboxes[i]),
                                   rtol=0, atol=1e-2)


# -------------------------------------------------------------- weights
@pytest.mark.parametrize('kind', list(CONFIGS))
def test_every_jax_leaf_maps_to_one_port_tensor(models, kind):
    """params_from_jax gives one port tensor per erd_tpu leaf, of the same
    size, and they are exactly the port network's state (strict load)."""
    m = models(kind)
    leaves = jax.tree_util.tree_leaves_with_path(m['variables'])
    state = params_from_jax(m['variables'])
    port = m['net'].state_dict()
    assert len(state) == len(leaves) and set(state) == set(port)
    assert sorted(int(np.size(v)) for _, v in leaves) == \
        sorted(int(t.numel()) for t in state.values())
    head = {k for k in state if k.startswith('bbox_head.')}
    assert 'bbox_head.encoder_0.self_attn.value_proj.weight' in head
    assert state['bbox_head.decoder_5.self_attn.out.weight'].shape == (C, C)
    if kind == 'dino':
        assert state['bbox_head.dn_label_embed.weight'].shape == \
            (NUM_CLASSES, C)
        assert state['bbox_head.query_embed'].shape == (NUM_QUERIES, C)
    else:
        assert state['bbox_head.query_embed'].shape == (NUM_QUERIES, 2 * C)
    assert {f'neck.{n}_{i}.weight' for n in ('conv', 'gn')
            for i in range(3)} | {'neck.extra_conv_0.weight',
                                  'neck.extra_gn_0.weight'} <= set(state)


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_detr_configs_build_and_unported_paths_raise(kind, tmp_path):
    cfg = Config.fromfile(os.path.join(ROOT, CONFIGS[kind]))
    det = build_detector(cfg.model)
    want = {'dino': (DINODetector, 900, 300),
            'deformable_detr': (DeformableDETRDetector, 300, 100)}[kind]
    assert type(det) is want[0]
    assert (det.num_queries, det.max_per_img) == want[1:]
    assert det.compute_dtype == torch.bfloat16 and det.depth == 50
    assert det.frozen_stages == 1
    small = type(det)(num_classes=NUM_CLASSES, depth=18, num_queries=4)
    net = small.init(seed=0, device='cpu')
    # training is ported: the loss gives erd_tpu's keys
    gt = stack_to([GTInstances.pad(np.array([[8, 8, 40, 30]], np.float32),
                                   [1], 2)], 'cpu')
    batch = dict(images=torch.zeros((1,) + CANVAS + (3,), dtype=torch.uint8),
                 gt=gt, meta=stack_to([ImageMeta.make(CANVAS, CANVAS,
                                                      (1.0, 1.0))], 'cpu'))
    with torch.no_grad():
        losses = small.loss(net, batch)
    sfx = ['', *(f'_aux{i}' for i in range(5))]
    want = {f'loss_{n}{s}' for n in ('cls', 'bbox', 'giou') for s in sfx}
    if kind == 'dino':
        want |= {f'loss_dn_{n}{s}' for n in ('cls', 'bbox', 'giou')
                 for s in sfx} | {f'loss_enc_{n}' for n in ('cls', 'bbox',
                                                            'giou')}
    assert set(losses) == want
    assert all(bool(torch.isfinite(v)) for v in losses.values())
    path = tmp_path / 'mmdet.pth'
    torch.save({'state_dict': net.state_dict()}, path)
    with pytest.raises(NotImplementedError, match='not mmdet'):
        load_torch_checkpoint_file(net, str(path))
