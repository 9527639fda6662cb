"""Port parity of CornerNet training on the CPU: the corner-pool backward
(erd_tpu's tie rule), the gaussian radius and corner targets, the gaussian
focal and associative-embedding losses, train-mode BN, one Adam step, the
loss, every gradient and the updated BN statistics of a small CornerNet
against erd_tpu's ``value_and_grad`` / ``loss_and_state``, and
``build_trainer`` + ``fit``.

The network is tests/test_torch_cornernet.py's small hourglass (channels
(16, 16, 24), 2 downsamplings, 2 stacks, 4 classes) with erd_tpu's weights
through ``params_from_jax`` (BN statistics and biases perturbed), B = 2
images in a 64x96 canvas, float32 on both sides. Tolerances, each with its
reason:
- the corner-pool backward against jax.grad: 1e-6 * max|g| (every input
  gradient is a sum of at most two products with 1 or 0.5, so it is equal
  in practice), on random rays and on tied ones: all zeros, runs of zeros,
  odd and even lengths, every direction;
- ``gaussian_radius``: exactly, boxes near an integer radius included (the
  port repeats the float32 ops of erd_tpu's jitted radius, its folded
  constants, and correctly rounded roots); ``render_corner_targets``: heat
  within 1e-6 (exp may differ by an ulp), the exact-1 peak count (the
  loss's avg_factor), offsets, weights and corner pixels equal;
- the losses from identical inputs: rtol 1e-6, gradients rtol 1e-5;
- train-mode BN: outputs, input and parameter gradients and the updated
  running statistics within 1e-6 (relative to their largest value);
- two Adam steps: two float32 ulps of each parameter and 1e-4 of the
  learning rate: optax takes the bias corrections 1 - beta^t in float32
  (0.999 rounds to 0.99900001), which moves its steps ~1e-5 off the exact
  Adam step; torch takes them in double and lands within an ulp of a
  float64 Adam;
- the network: the loss dict rtol 1e-5; ||diff|| / ||g|| <= 1e-4 over all
  gradients and 1e-3 for each tensor (1.6e-5 measured: the train-mode BN
  backward removes the common part of the heads' gradient and leaves
  float32 noise of both sides magnified, ~7e-5 each against a float64 run
  of the port); the updated running statistics within 1e-5 of erd_tpu's
  ``new_state['batch_stats']``, relative to each tensor's largest value
  (0.1 of a batch statistic that ~40 float32 layers feed: the network's
  outputs themselves differ by 1e-5).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from erd_tpu.engine.optim import adamw_optimizer as j_adamw_optimizer
from erd_tpu.losses import associative_embedding_loss as j_ae_loss
from erd_tpu.losses import gaussian_focal_loss as j_gfocal
from erd_tpu.models.backbones.hourglass import _ConvBN as JConvBN
from erd_tpu.models.detectors.cornernet import \
    CornerNetDetector as JCornerNet
from erd_tpu.ops import corner_pool as j_corner_pool
from erd_tpu.ops.gaussian import gaussian_radius as j_gaussian_radius
from erd_tpu.ops.gaussian import render_corner_targets as j_render
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu_torch.apis import build_trainer
from erd_tpu_torch.config import Config
from erd_tpu_torch.engine import adam_optimizer
from erd_tpu_torch.losses import (associative_embedding_loss,
                                  gaussian_focal_loss)
from erd_tpu_torch.models import CornerNetDetector
from erd_tpu_torch.models.backbones.hourglass import ConvBN
from erd_tpu_torch.models.weight_import import (batch_stats_to_jax,
                                                 params_from_jax)
from erd_tpu_torch.ops import corner_pool
from erd_tpu_torch.ops.extra_nms import (corner_pool_backward,
                                         corner_pool_backward_plain,
                                         corner_pool_plain)
from erd_tpu_torch.ops.gaussian import (gaussian_radius,
                                        render_corner_targets)
from erd_tpu_torch.structures import GTInstances
from tests.test_torch_cornernet import (SMALL, nan_rays, nchw, perturbed,
                                        to_numpy)
from tests.test_torch_train import OneBatchLoader, Recorder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'cornernet',
                      'cornernet_hourglass104_8xb6-210e-mstest_coco.py')
CANVAS = (64, 96)
MAX_GT = 5
GTS = [([[4, 6, 40, 50], [30, 10, 90, 44], [50.5, 20.25, 80.75, 60],
         [5, 30, 22, 62]], [1, 3, 0, 1]),
       ([[2, 2, 30, 30], [40, 16, 94, 63], [41, 17, 93, 62]], [2, 1, 1])]
DIRECTIONS = ['top', 'bottom', 'left', 'right']


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_close(got, want, rel):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------- corner_pool backward
def tied_rays(n):
    """(1, n, n, 4) NHWC maps whose rays along both axes tie: all zeros,
    ReLU'd noise (runs of zeros), a plateau with a lattice of peaks, values
    on a half-integer grid."""
    rs = np.random.RandomState(n)
    x = np.zeros((4, n, n), np.float32)
    x[1] = np.maximum(rs.randn(n, n), 0).astype(np.float32)
    x[2] = 0.75
    x[2, ::3, ::2] = 1.5
    x[3] = np.floor(rs.rand(n, n) * 3) / 2
    return x.transpose(1, 2, 0)[None]


@pytest.mark.parametrize('direction', DIRECTIONS)
@pytest.mark.parametrize('case', ['random', 'tied4', 'tied5', 'tied8',
                                  'tied13'])
def test_corner_pool_backward_matches_jax_grad(direction, case):
    if case == 'random':
        x = np.random.RandomState(0).randn(2, 7, 9, 3).astype(np.float32)
    else:
        x = tied_rays(int(case[4:]))
    g = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda a: (j_corner_pool(
        a, direction) * g).sum()))(jnp.asarray(x)))
    got = corner_pool_backward_plain(nchw(x), nchw(g), direction)
    rel_close(nhwc(got), want, 1e-6)
    tx = nchw(x).requires_grad_()
    corner_pool(tx, direction).backward(nchw(g))
    assert torch.equal(tx.grad, got)
    if case != 'random':  # torch.cummax's own rule differs on the ties
        with torch.enable_grad():
            a = nchw(x).requires_grad_()
            cummax, = torch.autograd.grad(
                (corner_pool_plain(a, direction) * nchw(g)).sum(), a)
        assert not torch.allclose(cummax, got)


@pytest.mark.parametrize('direction', DIRECTIONS)
@pytest.mark.parametrize('case', ['repro', 'scattered', 'scattered_ones'])
def test_corner_pool_backward_with_nan_matches_jax_grad(direction, case):
    """Fault 3.11: where a combine's output is NaN, lax.max's _balanced_eq
    sends no gradient to either operand (torch.maximum's rule sends all of
    it to both); the plain version, and the Function through it, give
    jax.grad's gradient (the repro's values given)."""
    x = nan_rays(case.replace('_ones', ''), direction)
    rs = np.random.RandomState(2)
    g = (np.arange(1, 7, dtype=np.float32).reshape(x.shape)
         if case == 'repro' else np.ones_like(x) if case.endswith('ones')
         else rs.randn(*x.shape).astype(np.float32))
    want = np.asarray(jax.jit(jax.grad(lambda a: (j_corner_pool(
        a, direction) * g).sum()))(jnp.asarray(x)))
    assert np.isfinite(want).all()
    got = corner_pool_backward_plain(nchw(x), nchw(g), direction)
    rel_close(nhwc(got), want, 1e-6)
    if case == 'repro':
        expect = {'bottom': [1, 0, 0, 0, 0, 0], 'right': [1, 0, 0, 0, 0, 0],
                  'top': [0, 0, 0, 3.5, 8.5, 6],
                  'left': [0, 0, 0, 3.5, 8.5, 6]}[direction]
        assert got.flatten().tolist() == expect
    tx = nchw(x).requires_grad_()
    corner_pool(tx, direction).backward(nchw(g))
    assert torch.equal(tx.grad, got)


def test_corner_pool_backward_tie_shares_and_gradcheck():
    """The gradient of sum(cummax) of a tied ray is JAX's tree split
    ([2, 1, 0.75, 0.25] for four zeros), not torch.cummax's; gradcheck of
    the Function in float64 away from ties; bf16 sums in float32."""
    for n, want in ((4, [2, 1, 0.75, 0.25]),
                    (5, [2.125, 1.125, 0.875, 0.375, 0.5])):
        x = torch.zeros(1, 1, 1, n)
        got = corner_pool_backward(x, torch.ones_like(x), 'right')
        assert got.flatten().tolist() == want
        flipped = corner_pool_backward(x, torch.ones_like(x), 'left')
        assert flipped.flatten().tolist() == want[::-1]
    x = torch.randn(1, 2, 5, 4, dtype=torch.float64).requires_grad_()
    for d in DIRECTIONS:
        assert torch.autograd.gradcheck(lambda a: corner_pool(a, d), (x,))
    xb = torch.zeros(1, 1, 3, 6, dtype=torch.bfloat16)
    gb = corner_pool_backward(xb, torch.ones_like(xb), 'bottom')
    assert gb.dtype == torch.bfloat16
    assert gb[0, 0, :, 0].tolist() == [1.75, 0.75, 0.5]


# ---------------------------------------------------- targets and losses
def test_gaussian_radius_matches_jax_exactly():
    """Random box sizes, and sizes whose radius sits within 1e-3 of an
    integer, equal to erd_tpu's jitted radius to the bit, and their floor
    too."""
    rs = np.random.RandomState(2)
    h = np.ceil(rs.uniform(0, 300, 30000)).astype(np.float32)
    w = np.ceil(rs.uniform(0, 300, 30000)).astype(np.float32)
    want = np.asarray(jax.jit(j_gaussian_radius)(h, w))
    near = np.abs(want - np.round(want)) < 1e-3
    assert near.sum() > 20
    got = gaussian_radius(torch.from_numpy(h), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.floor(got[near]), np.floor(want[near]))


def numpy_gt():
    return [JGTInstances.pad(np.asarray(b, np.float32), lab, MAX_GT)
            for b, lab in GTS]


def test_render_corner_targets_matches_jax():
    gt = numpy_gt()
    fh, fw = CANVAS[0] // 4, CANVAS[1] // 4
    ratio = (fw / CANVAS[1], fh / CANVAS[0])
    stack = [np.stack([getattr(g, k) for g in gt])
             for k in ('bboxes', 'labels', 'mask')]
    want = jax.jit(jax.vmap(lambda b, l, m: j_render(
        b, l, m, (fh, fw), 4, jnp.asarray(ratio, jnp.float32))))(*stack)
    got = render_corner_targets(*[torch.from_numpy(a) for a in stack],
                                (fh, fw), 4, ratio)
    for c in ('tl', 'br'):
        w_heat = np.asarray(want[f'{c}_heat'])
        rel_close(nhwc(got[f'{c}_heat']), w_heat, 1e-6)
        assert int((got[f'{c}_heat'] == 1).sum()) == int((w_heat == 1).sum())
        for k in ('off', 'w'):
            np.testing.assert_array_equal(nhwc(got[f'{c}_{k}']),
                                          np.asarray(want[f'{c}_{k}']))
        np.testing.assert_array_equal(got[f'{c}_xy'].numpy(),
                                      np.asarray(want[f'{c}_xy']))
    assert int((got['tl_heat'] == 1).sum()) >= 5


def test_gaussian_focal_and_ae_losses_match_jax():
    rs = np.random.RandomState(3)
    logits = rs.randn(2, 6, 8, 4).astype(np.float32) * 2
    target = (rs.rand(2, 6, 8, 4) ** 3).astype(np.float32)
    target[0, 1, 2, 0] = target[1, 3, 3, 2] = 1.0

    def jloss(lg):
        return j_gfocal(jax.nn.sigmoid(lg), target, reduction='none').sum()
    want, gw = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = gaussian_focal_loss(torch.sigmoid(tl), torch.from_numpy(target),
                              reduction='none').sum()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-7)
    emb = rs.randn(3, 2, 5).astype(np.float32) * 0.6
    mask = np.array([[1, 1, 1, 0, 1], [0, 1, 0, 0, 0], [0] * 5], bool)
    want_pull, want_push = jax.vmap(lambda a, b, m: j_ae_loss(
        a, b, m, 0.1, 0.1))(emb[:, 0], emb[:, 1], mask)
    te = torch.from_numpy(emb).requires_grad_()
    pull, push = associative_embedding_loss(te[:, 0], te[:, 1],
                                            torch.from_numpy(mask), 0.1, 0.1)
    np.testing.assert_allclose(pull.detach().numpy(),
                               np.asarray(want_pull), rtol=1e-6)
    np.testing.assert_allclose(push.detach().numpy(),
                               np.asarray(want_push), rtol=1e-6)
    assert push[1] == 0 and push[2] == 0 and pull[2] == 0
    (pull.sum() + 2 * push.sum()).backward()
    gj = jax.grad(lambda e: sum(jnp.sum(t * s) for t, s in zip(
        jax.vmap(lambda a, b, m: j_ae_loss(a, b, m, 0.1, 0.1))(
            e[:, 0], e[:, 1], mask), (1.0, 2.0))))(jnp.asarray(emb))
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-8)


# ------------------------------------------------------- train-mode BN
def test_train_mode_bn_matches_flax():
    """erd_tpu's _ConvBN in train mode (flax BatchNorm, momentum 0.9, fast
    biased variance): the output, its gradients in x and the parameters,
    and the updated running statistics; eval mode reads them back."""
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 9, 11, 6) * 2 + 1).astype(np.float32)
    jmod = JConvBN(8, 3)
    variables = perturbed(to_numpy(jmod.init(jax.random.PRNGKey(2),
                                             jnp.asarray(x))), seed=5)
    g = rs.randn(3, 9, 11, 8).astype(np.float32)

    def f(params, a):
        out, state = jmod.apply({'params': params,
                                 'batch_stats': variables['batch_stats']},
                                a, True, mutable=['batch_stats'])
        return (out * g).sum(), (out, state)
    (_, (want, state)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables['params'], jnp.asarray(x))
    mod = ConvBN(6, 8, 3)
    # an empty tl_pool_0 scope marks the tree as CornerNet's
    state_dict = params_from_jax(dict(
        params={'m': variables['params'], 'tl_pool_0': {}},
        batch_stats={'m': variables['batch_stats']}))
    mod.load_state_dict({k[len('m.'):]: v for k, v in state_dict.items()})
    mod.train()
    tx = nchw(x).requires_grad_()
    out = mod(tx)
    rel_close(nhwc(out), want, 1e-6)
    out.backward(nchw(g))
    rel_close(nhwc(tx.grad), gx, 1e-6)
    rel_close(mod.bn.weight.grad.numpy(), gp['bn']['scale'], 1e-6)
    rel_close(mod.bn.bias.grad.numpy(), gp['bn']['bias'], 1e-6)
    rel_close(mod.conv.weight.grad.permute(2, 3, 1, 0).numpy(),
              gp['conv']['kernel'], 1e-6)
    new = state['batch_stats']['bn']
    rel_close(mod.bn.running_mean.numpy(), new['mean'], 1e-6)
    rel_close(mod.bn.running_var.numpy(), new['var'], 1e-6)
    mod.eval()
    with torch.no_grad():
        eval_out = mod(nchw(x))
    want_eval = jmod.apply({'params': variables['params'],
                            'batch_stats': state['batch_stats']},
                           jnp.asarray(x))
    rel_close(nhwc(eval_out), want_eval, 1e-6)


# ---------------------------------------------------------------- Adam
def test_one_adam_step_matches_erd_tpus_optimizer():
    """erd_tpu's Adam (AdamW with zero decay, frozen_stages 1) against
    ``torch.optim.Adam(weight_decay=0)`` on the small CornerNet's
    parameters and seeded gradients: two steps; ``backbone.stem_conv`` is
    not trained on either side (erd_tpu's ResNet prefix 'stem_conv' names
    the hourglass stem)."""
    jdet = JCornerNet(**SMALL)
    params = to_numpy(jdet.init(jax.random.PRNGKey(0),
                                image_shape=CANVAS))['params']
    rs = np.random.RandomState(6)
    grads = [jax.tree.map(lambda p: rs.randn(*p.shape).astype(np.float32),
                          params) for _ in range(2)]
    lr = 5e-4
    tx = j_adamw_optimizer(lambda c: lr, weight_decay=0.0, frozen_stages=1)
    state = tx.init(params)
    jp = params
    for gr in grads:
        upd, state = tx.update(gr, state, jp)
        jp = optax.apply_updates(jp, upd)
    det = CornerNetDetector(**SMALL)
    net = det.build_net()
    net.load_state_dict(params_from_jax({'params': params}), strict=False)
    start = copy.deepcopy(net.state_dict())
    opt = adam_optimizer(net, lr)
    named = dict(net.named_parameters())
    for gr in grads:
        gt = params_from_jax({'params': to_numpy(gr)})
        for k, p in named.items():
            p.grad = gt[k].clone() if p.requires_grad else None
        opt.step()
    want = params_from_jax({'params': to_numpy(jp)})
    frozen = [k for k, p in named.items() if not p.requires_grad]
    assert frozen and all(k.startswith('backbone.stem_conv.')
                          for k in frozen)
    for k, p in named.items():
        w, s = want[k], start[k]
        assert torch.equal(w, s) == (k in frozen), k
        if k in frozen:
            assert torch.equal(p.detach(), s), k
        else:  # two float32 ulps of the parameter, 1e-4 of a step
            d = (p.detach() - w).abs()
            assert bool((d <= 2.4e-7 * w.abs() + 1e-4 * lr).all()), k


# ------------------------------------------------------ the network
def perturbed_but_heat_prior(variables):
    """``perturbed``, but the heatmap heads keep erd_tpu's prior-0.1 bias,
    as training starts from it: at a 0.5 prior every negative pixel pulls
    the logits alike, and the train-mode BN backward, which removes that
    common part, then leaves float32 noise of ~1e-3 of what remains."""
    keep = {(f'{c}_heat_{i}', 'out', 'bias'): np.array(
        variables['params'][f'{c}_heat_{i}']['out']['bias'])
        for c in ('tl', 'br') for i in range(2)}
    variables = perturbed(variables)
    for (head, mod, leaf), value in keep.items():
        variables['params'][head][mod][leaf][...] = value
    return variables


@pytest.fixture(scope='module')
def cornernet_run():
    """erd_tpu's small CornerNet, its loss_and_state's losses, gradients
    and updated batch_stats on one batch."""
    jdet = JCornerNet(**SMALL)
    variables = perturbed_but_heat_prior(to_numpy(jdet.init(
        jax.random.PRNGKey(0), image_shape=CANVAS)))
    images = np.random.RandomState(7).randint(0, 256, (2, *CANVAS, 3),
                                              np.uint8)
    gt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *numpy_gt())
    batch = dict(images=jnp.asarray(images), gt=gt)
    consts = {k: v for k, v in variables.items() if k != 'params'}

    def total(params):
        losses, state = jdet.loss_and_state({'params': params, **consts},
                                            batch)
        return sum(losses.values()), (losses, state)
    (_, (losses, state)), grads = jax.jit(jax.value_and_grad(
        total, has_aux=True))(variables['params'])
    return dict(variables=variables, images=images,
                losses={k: float(v) for k, v in losses.items()},
                grads=params_from_jax(to_numpy({'params': grads})),
                batch_stats=to_numpy(state['batch_stats']))


def port_gt():
    gt = numpy_gt()
    return GTInstances(**{k: torch.from_numpy(np.stack([getattr(g, k)
                                                        for g in gt]))
                          for k in ('bboxes', 'labels', 'mask')})


def test_loss_grads_and_bn_state_match_jax(cornernet_run):
    """The small CornerNet's loss dict, every parameter gradient (nothing
    frozen here, so that the stem's is held too) and the running
    statistics its train-mode BN left, against erd_tpu's."""
    run = cornernet_run
    det = CornerNetDetector(**SMALL, frozen_stages=-1)
    net = det.init(seed=0, device='cpu')
    net.load_state_dict(params_from_jax(run['variables']), strict=True)
    losses = det.loss(net, dict(images=torch.from_numpy(run['images']),
                                gt=port_gt()))
    assert not net.training
    assert list(losses) == ['loss_heatmap', 'loss_pull', 'loss_push',
                            'loss_offset']
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), run['losses'][k], rtol=1e-5,
                                   err_msg=k)
        assert v.item() > 0, k
    sum(losses.values()).backward()
    diffs, refs = [], []
    for name, p in net.named_parameters():
        w = run['grads'][name].double().flatten()
        d = p.grad.double().flatten() - w
        assert d.norm() <= 1e-3 * w.norm(), (name, float(d.norm() /
                                                          w.norm()))
        diffs.append(d)
        refs.append(w)
    assert float(torch.cat(diffs).norm() / torch.cat(refs).norm()) <= 1e-4
    got = batch_stats_to_jax(net)
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(
            run['batch_stats']):
        node = got
        for key in path:
            node = node[key.key]
        rel_close(node, want, 1e-5)
        n += 1
    assert n == sum(1 for k in net.state_dict() if k.endswith(
        'running_mean')) * 2


def test_fit_two_steps_with_the_configs_adam():
    """build_trainer of the HG-104 config (Adam, lr 5e-4, multistep) + fit
    of the small CornerNet for two steps on the CPU: finite losses, every
    trainable weight and the BN running statistics moved, the stem
    unchanged; a decayed AdamW still raises."""
    cfg = Config.fromfile(CONFIG)
    cfg.train_cfg.epochs = 1
    cfg.optim.update(warmup_factor=1.0)
    det = CornerNetDetector(**SMALL)
    net = det.init(seed=3, device='cpu')
    start = copy.deepcopy(net.state_dict())
    rec = Recorder()
    batch = dict(images=torch.from_numpy(np.random.RandomState(8).randint(
        0, 256, (2, *CANVAS, 3), np.uint8)), gt=port_gt())
    trainer = build_trainer(cfg, det, OneBatchLoader(batch, 2),
                            device='cpu')
    trainer.hooks.append(rec)
    trainer.fit(net)
    assert isinstance(trainer.optimizer, torch.optim.Adam)
    assert trainer.optimizer.defaults['weight_decay'] == 0
    assert len(rec.losses) == 2
    for losses in rec.losses:
        assert all(np.isfinite(v) for v in losses.values()), losses
    trainable = {k for k, p in net.named_parameters() if p.requires_grad}
    for name, value in net.state_dict().items():
        moved = not torch.equal(value, start[name])
        if name.startswith('backbone.stem_conv.') and 'running' not in name:
            assert not moved and name not in trainable, name
        elif name in trainable and value.dim() > 1 or 'running' in name:
            assert moved, name
    bad = Config.fromfile(CONFIG)
    bad.optim_wrapper.optimizer.update(type='AdamW')
    bad.optim.update(weight_decay=0.05)
    with pytest.raises(NotImplementedError, match='Zoo'):
        build_trainer(bad, det, OneBatchLoader(batch, 2), device='cpu')
