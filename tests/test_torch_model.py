"""Port parity: erd_tpu_torch's GFL network, gfl_predict and weight import
vs erd_tpu, fp32 on the CPU.

Parameters go JAX -> numpy -> ``params_from_jax``. The network output is
held to 1e-4 * max|out|: erd_tpu computes the stem as a space-to-depth
4x4 conv, which reassociates the sums of the port's plain 7x7/2 conv.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.detectors.single_stage import GFLNet as JGFLNet
from erd_tpu.models.heads.gfl_head import AnchorContext as JAnchorContext
from erd_tpu.models.heads.gfl_head import GFLTestConfig as JTestConfig
from erd_tpu.models.heads.gfl_head import gfl_predict as j_gfl_predict
from erd_tpu.models.weight_import import load_mmdet_state_dict
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.models.detectors.single_stage import GFLNet
from erd_tpu_torch.models.heads.gfl_head import (AnchorContext,
                                                 GFLTestConfig, gfl_predict)
from erd_tpu_torch.models.weight_import import (load_torch_checkpoint_file,
                                                 params_from_jax)
from erd_tpu_torch.structures import ImageMeta, stack_to

torch.set_num_threads(2)

NUM_CLASSES = 8


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def perturb(variables, rs):
    """Non-trivial norm statistics and affine params, Scale values."""
    def walk(tree, path=''):
        out = {}
        for k, v in tree.items():
            p = f'{path}/{k}'
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif k == 'mean':
                out[k] = rs.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == 'var':
                out[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == 'scale':
                out[k] = (rs.uniform(0.5, 1.5, v.shape) if v.ndim == 0 else
                          rs.normal(1, 0.2, v.shape)).astype(np.float32)
            elif k == 'bias':
                out[k] = rs.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out
    return {c: walk(t) for c, t in variables.items()}


def jax_net(depth, x, seed=0):
    net = JGFLNet(num_classes=NUM_CLASSES, depth=depth, neck_out=64,
                  stacked_convs=2)
    variables = to_numpy(jax.jit(net.init)(jax.random.PRNGKey(seed),
                                           jnp.asarray(x)))
    return net, perturb(variables, np.random.RandomState(seed))


def port_net(depth, variables):
    net = GFLNet(NUM_CLASSES, depth=depth, neck_out=64, stacked_convs=2)
    net.load_state_dict(params_from_jax(variables), strict=True)
    return net.eval()


@pytest.mark.parametrize('depth', [18, 50])
def test_gfl_network_forward_matches_jax(depth):
    x = np.random.RandomState(depth).randn(1, 64, 96, 3).astype(np.float32)
    jnet, variables = jax_net(depth, x)
    cls_j, reg_j = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    net = port_net(depth, variables)
    with torch.no_grad():
        cls_t, reg_t = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in zip(list(cls_t) + list(reg_t), list(cls_j) +
                         list(reg_j)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape  # NHWC on both sides
        tol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_state_dict_round_trips_through_erd_tpu_import():
    x = np.zeros((1, 64, 96, 3), np.float32)
    jnet, variables = jax_net(50, x, seed=1)
    net = port_net(50, variables)
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    template = to_numpy(jax.jit(jnet.init)(jax.random.PRNGKey(9),
                                           jnp.asarray(x)))
    back, n = load_mmdet_state_dict(template, state, strict=True)
    assert n == len(state)
    flat_back = jax.tree_util.tree_leaves_with_path(to_numpy(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_gfl_predict_matches_jax():
    """Head outputs fed to both post-processings. Logits sit on a 1/64
    grid, so equal scores are exact ties on both sides and the sigmoids'
    last-bit differences cannot reorder candidates."""
    canvas = (128, 192)
    rs = np.random.RandomState(0)
    jctx = JAnchorContext.build(canvas)
    ctx = AnchorContext.build(canvas)
    b = 2
    cls, reg = [], []
    for h, w in jctx.featmap_sizes:
        cls.append(np.round(rs.normal(-1.0, 1.5, (b, h, w, NUM_CLASSES)) *
                            64).astype(np.float32) / 64)
        reg.append((rs.randn(b, h, w, 68) * 2).astype(np.float32))
    metas = [JImageMeta.make((120, 180), (240, 360), (0.5, 0.5)),
             JImageMeta.make((128, 96), (200, 150), (0.64, 0.64))]
    cfg = dict(score_thr=0.05, nms_pre=200, iou_threshold=0.6,
               max_per_img=50, pre_nms_total=400)
    jmeta = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *metas)
    want = j_gfl_predict(jctx, [jnp.asarray(c) for c in cls],
                         [jnp.asarray(r) for r in reg], jmeta,
                         JTestConfig(**cfg))
    pmetas = [ImageMeta(**{f: np.asarray(getattr(m, f)) for f in
                           ('img_shape', 'ori_shape', 'scale_factor', 'flip',
                            'img_id', 'valid')}) for m in metas]
    got = gfl_predict(ctx, [torch.from_numpy(c) for c in cls],
                      [torch.from_numpy(r) for r in reg],
                      stack_to(pmetas, 'cpu'), GFLTestConfig(**cfg))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.sum() > 20
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(want.bboxes),
                               rtol=0, atol=1e-4)


def test_mmdet_checkpoint_file_loads(tmp_path):
    """An mmdet-style .pth (``state_dict`` key, ``module.`` prefixes, BN
    ``num_batches_tracked``) loads into the port's network by name."""
    x = np.zeros((1, 64, 96, 3), np.float32)
    _, variables = jax_net(18, x, seed=2)
    state = {f'module.{k}': v for k, v in params_from_jax(variables).items()}
    state['module.backbone.bn1.num_batches_tracked'] = torch.tensor(0)
    path = tmp_path / 'gfl.pth'
    torch.save({'state_dict': state, 'meta': {'epoch': 12}}, path)
    net = GFLNet(NUM_CLASSES, depth=18, neck_out=64, stacked_convs=2)
    load_torch_checkpoint_file(net, str(path))
    for k, v in net.state_dict().items():
        assert torch.equal(v, state[f'module.{k}']), k
