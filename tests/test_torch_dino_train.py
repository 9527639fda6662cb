"""Port parity of DINO training on the CPU: the contrastive denoising
queries on erd_tpu's own draws, their attention mask, the DINO loss, the
detached initial reference boxes, the loss and every gradient of the
network against erd_tpu, and ``build_trainer`` + ``fit``.

The network, batch and tolerances are ``tests/test_torch_detr_train.py``'s
(DINO at ResNet-18, 4 classes, 20 queries, the sampling weights arranged
on both sides, its zero ``fc_reg`` seeded; B = 2 images in a 64x96 canvas,
MAX_GT = 4, so D = 24 denoising and T = 44 decoder queries). The denoising
draws are erd_tpu's: the split of ``fold_in(PRNGKey(7), img_id.sum())``
drawn here with jax.random and handed to the port's ``draws``. Further
tolerances:
- the denoising labels and valid mask exactly, the boxes within 1 ulp
  (the same float32 ops; XLA may fuse the noise products);
- the attention mask exactly;
- the DINO loss from identical head outputs: rtol 1e-5, its gradients in
  the outputs rtol 1e-5 with atol 1e-6 * max|g|.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erd_tpu.models.heads.dino_head import dino_loss as j_dino_loss
from erd_tpu.models.heads.dino_head import \
    make_dn_attn_mask as j_make_dn_attn_mask
from erd_tpu.models.heads.dino_head import make_dn_queries as j_make_dn
from erd_tpu_torch.models.heads.dino_head import (dino_loss,
                                                  make_dn_attn_mask,
                                                  make_dn_queries)
from tests.test_torch_detr import CANVAS, NUM_CLASSES
from tests.test_torch_detr_train import (IMG_IDS, MAX_GT, build,
                                         check_fit, check_loss_from_feats,
                                         check_whole_network, grid,
                                         jax_dn_draws, jax_train_run,
                                         numpy_batch, port_batch)

torch.set_num_threads(2)

NUM_DN = 2 * MAX_GT * 3


# ------------------------------------------------------ denoising queries
@pytest.mark.parametrize('groups', [3, 2])
def test_make_dn_queries_matches_jax_draws(groups):
    """Gt boxes on the 1/64 grid, some at the canvas edges (the noise is
    clipped to [0, 1], w and h to [1e-4, 1]), padded slots, a high label
    noise so that labels are replaced."""
    rs = np.random.RandomState(groups)
    b, g, nc = 3, 5, 7
    ctr = grid(rs.uniform(0, 1, (b, g, 2)))
    wh = grid(rs.uniform(1 / 64, 0.9, (b, g, 2)))
    ctr[0, 0], wh[0, 0] = (0.0, 1.0), (1.0, 1 / 64)
    boxes = np.concatenate([ctr, wh], -1)
    labels = rs.randint(0, nc, (b, g))
    mask = rs.rand(b, g) > 0.3
    mask[2] = False
    rng = jax.random.PRNGKey(11)
    kw = dict(dn_groups=groups, label_noise_scale=0.8, box_noise_scale=1.0)
    want = jax.jit(lambda r: j_make_dn(
        r, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), nc,
        **kw))(rng)
    d = 2 * g * groups
    r1, r2, r3, r4 = jax.random.split(rng, 4)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(r1, (b, d)), jax.random.randint(r2, (b, d), 0, nc),
        jax.random.randint(r3, (b, d, 4), 0, 2),
        jax.random.uniform(r4, (b, d, 4))))
    got = make_dn_queries(torch.from_numpy(boxes), torch.from_numpy(labels),
                          torch.from_numpy(mask), nc, draws, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[1].dtype == torch.float32
    np.testing.assert_array_max_ulp(got[1].numpy(), np.asarray(want[1]), 1)
    tiled = np.tile(labels, (1, 2 * groups))
    assert (got[0].numpy() != tiled).any()  # labels were flipped
    assert (got[1][..., :2] == 0).any() and (got[1][..., :2] == 1).any()
    assert float(got[1][..., 2:].min()) >= 1e-4


@pytest.mark.parametrize('num_dn,num_matching,groups',
                         [(24, 20, 3), (16, 5, 2), (0, 7, 3)])
def test_make_dn_attn_mask_matches_jax(num_dn, num_matching, groups):
    got = make_dn_attn_mask(num_dn, num_matching, groups)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_make_dn_attn_mask(num_dn, num_matching,
                                                    groups)))


# ------------------------------------------------------------------ loss
def test_dino_loss_matches_jax():
    """Two decoder layers of D = 24 denoising and 15 matching queries and
    the encoder's 15 selected tokens, from identical outputs (boxes on a
    1/4096 grid: see test_deformable_detr_loss_matches_jax); the padded
    gt slots make invalid denoising slots."""
    rs = np.random.RandomState(6)
    _, gt, _ = numpy_batch()
    jgt = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *gt)
    layers, q = 2, 15
    t = NUM_DN + q
    outs = dict(all_cls=grid(rs.randn(layers, 2, t, NUM_CLASSES) * 2),
                all_boxes=grid(rs.uniform(0.1, 0.6, (layers, 2, t, 4)),
                               4096),
                enc_cls=grid(rs.randn(2, q, NUM_CLASSES) * 2),
                enc_boxes=grid(rs.uniform(0.1, 0.6, (2, q, 4)), 4096))
    dn_valid = np.tile(np.stack([g.mask for g in gt]), (1, 6))

    def jtotal(o):
        parts = j_dino_loss(dict(o, num_dn=NUM_DN), jgt, CANVAS,
                            NUM_CLASSES, dn_valid=jnp.asarray(dn_valid))
        return sum(parts.values()), parts
    (want, parts), jgrads = jax.jit(jax.value_and_grad(
        jtotal, has_aux=True))({k: jnp.asarray(v) for k, v in outs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_()
             for k, v in outs.items()}
    got = dino_loss(dict(touts, num_dn=NUM_DN), port_batch()['gt'], CANVAS,
                    NUM_CLASSES, dn_valid=torch.from_numpy(dn_valid))
    assert set(got) == set(parts) and len(got) == 2 * 6 + 3
    for k in parts:
        np.testing.assert_allclose(got[k].item(), float(parts[k]),
                                   rtol=1e-5, err_msg=k)
    total = sum(got.values())
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    total.backward()
    for k, v in touts.items():
        w = np.asarray(jgrads[k])
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


# ------------------------------------------------------ the whole slice
@pytest.fixture(scope='module')
def dino():
    m = build('dino')
    m['run'] = jax_train_run('dino', m)
    m['draws'] = jax_dn_draws(sum(IMG_IDS), 2, NUM_DN)
    return m


def head_loss(det, draws):
    """``loss_fn`` of check_loss_from_feats: DINO's head with the
    denoising queries of ``draws`` and its loss, as ``DINODetector.loss``
    runs them after the neck."""
    b = port_batch()
    gt = b['gt']
    norm = torch.tensor([CANVAS[1], CANVAS[0]] * 2, dtype=torch.float32)
    xyxy = gt.bboxes / norm
    cxcywh = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2,
                        xyxy[..., 2:] - xyxy[..., :2]], -1)
    labels, boxes, valid = make_dn_queries(cxcywh, gt.labels, gt.mask,
                                           det.num_classes, draws)
    mask = make_dn_attn_mask(NUM_DN, det.num_queries, 3)

    def loss_fn(net, feats):
        outs = net.bbox_head(feats, labels, boxes, mask)
        return dino_loss(outs, gt, CANVAS, det.num_classes, det.train_cfg,
                         dn_valid=valid)
    return loss_fn


def test_loss_from_feats_matches_jax(dino):
    check_loss_from_feats(dino, dino['run'],
                          head_loss(dino['det'], dino['draws']))


def test_whole_network_loss_and_grads_match_jax(dino):
    check_whole_network(dino, dino['run'], draws=dino['draws'])


def test_init_ref_is_detached(dino):
    """erd_tpu's stop_gradient(init_ref): the decoder's losses give the
    encoder's box regression (enc_reg_fc0, enc_reg_fc1, enc_reg) no
    gradient; only the encoder's own loss trains it through the selected
    boxes."""
    net = copy.deepcopy(dino['net'])
    rs = np.random.RandomState(1)
    feats = [torch.from_numpy(grid(rs.randn(2, 256, h, w)))
             for h, w in ((8, 12), (4, 6), (2, 3), (1, 2))]
    losses = head_loss(dino['det'], dino['draws'])(net, feats)
    head = net.bbox_head
    params = [p for m in (head.enc_reg_fc0, head.enc_reg_fc1, head.enc_reg)
              for p in m.parameters()]
    decoder = sum(v for k, v in losses.items() if '_enc_' not in k)
    encoder = sum(v for k, v in losses.items() if '_enc_' in k)
    from_decoder = torch.autograd.grad(decoder, params, retain_graph=True,
                                       allow_unused=True)
    assert all(g is None or not g.any() for g in from_decoder)
    from_encoder = torch.autograd.grad(encoder, params)
    assert all(g.abs().max() > 0 for g in from_encoder)
    # nor the proposal projection that feeds it (enc_output), while it
    # still trains what it reads: the encoder's memory and its queries
    assert torch.autograd.grad(decoder, head.enc_output.weight,
                               retain_graph=True, allow_unused=True)[0] \
        is None
    used = torch.autograd.grad(decoder, [head.encoder_5.ffn2.weight,
                                         head.query_embed])
    assert all(g.abs().max() > 0 for g in used)


def test_loss_draws_from_a_seeded_generator(dino):
    """Without ``draws`` the noise comes from a generator seeded with the
    batch's img_id sum: ``dn_draws`` of those ids, which differ for other
    ids."""
    det, net = dino['det'], dino['net']
    batch = port_batch()
    ids = batch['meta'].img_id
    draws = det.dn_draws(ids, 2, NUM_DN, 'cpu')
    assert [tuple(d.shape) for d in draws] == [(2, NUM_DN)] * 2 + \
        [(2, NUM_DN, 4)] * 2
    with torch.no_grad():
        a = det.loss(net, batch)
        b = det.loss(net, batch, draws=draws)
    assert all(torch.equal(a[k], b[k]) for k in a)
    other = det.dn_draws(ids + 1, 2, NUM_DN, 'cpu')
    assert all(not torch.equal(d, o) for d, o in zip(draws, other))


def test_fit_two_steps_from_the_dino_config():
    losses = check_fit('dino')
    sfx = ['', *(f'_aux{i}' for i in range(5))]
    assert set(losses[0]) == {
        f'loss_{p}{n}{s}' for p in ('', 'dn_') for n in ('cls', 'bbox',
                                                          'giou')
        for s in sfx} | {f'loss_enc_{n}' for n in ('cls', 'bbox', 'giou')}
