"""Port parity of the whole training slice on the CPU: the ERD loss and the
student's gradients, three SGD steps of ``Trainer.fit`` against erd_tpu's
optax step, ``widen_cls_head``, and the engine's own rules.

The toy detector: ResNet-18, FPN width 64, 2 head convs, 8 classes of which
4 are the teacher's, B = 2 images of 64x96, erd_tpu's weights carried over
by ``params_from_jax``. Tolerances (float32): the loss dict rtol 1e-4;
student gradients rtol 1e-3 with atol 1e-5 * max|g| of each tensor (the
stem is a space-to-depth conv in erd_tpu, so sums reassociate); parameters
after three SGD steps rtol 1e-4 with atol 1e-4 * max|p| of each tensor.
"""
import copy
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from erd_tpu.engine.optim import sgd_optimizer as j_sgd_optimizer
from erd_tpu.models.detectors.gfl_erd import ERDConfig as JERDConfig
from erd_tpu.models.detectors.gfl_erd import ERDDetector as JERDDetector
from erd_tpu.models.detectors.single_stage import GFLNet as JGFLNet
from erd_tpu.models.weight_import import widen_cls_head as j_widen_cls_head
from erd_tpu.structures.det_sample import GTInstances as JGTInstances
from erd_tpu.structures.det_sample import ImageMeta as JImageMeta
from erd_tpu_torch.apis import build_detector, build_trainer
from erd_tpu_torch.config import Config
from erd_tpu_torch.engine import (Hook, Trainer, TrainerConfig,
                                  resnet_frozen_paths, sgd_optimizer)
from erd_tpu_torch.models import ERDConfig, ERDDetector, GFLDetector, GFLNet
from erd_tpu_torch.models.weight_import import (params_from_jax,
                                                 widen_cls_head)
from erd_tpu_torch.structures import GTInstances, ImageMeta
from tests.test_torch_model import perturb, to_numpy
from tests.test_torch_serve import small_cfg

torch.set_num_threads(2)

NUM_CLASSES, ORI = 8, 4
SHAPE = (64, 96)
LR = 0.08
STEPS = 3
GTS = [([[10, 10, 60, 50], [30, 5, 90, 40]], [1, 3]),
       ([[5, 5, 40, 40]], [2])]


def jax_net(num_classes):
    return JGFLNet(num_classes=num_classes, depth=18, neck_out=64,
                   stacked_convs=2)


def port_net(num_classes, variables):
    net = GFLNet(num_classes, depth=18, neck_out=64, stacked_convs=2,
                 frozen_stages=1)
    net.load_state_dict(params_from_jax(variables), strict=True)
    return net.eval()


def numpy_batch():
    images = np.random.RandomState(0).randint(0, 255, (2,) + SHAPE + (3,),
                                              dtype=np.uint8)
    gt = [GTInstances.pad(np.asarray(b, np.float32), lab, 8)
          for b, lab in GTS]
    meta = [ImageMeta.make(SHAPE, SHAPE, (1.0, 1.0), img_id=i)
            for i in range(2)]
    def stack(items):
        return {f.name: np.stack([np.asarray(getattr(x, f.name))
                                  for x in items])
                for f in dataclasses.fields(items[0])}
    return images, stack(gt), stack(meta)


def port_batch():
    images, gt, meta = numpy_batch()
    return dict(images=torch.from_numpy(images),
                gt=GTInstances(**{k: torch.from_numpy(v)
                                  for k, v in gt.items()}),
                meta=ImageMeta(**{k: torch.from_numpy(v)
                                  for k, v in meta.items()}))


@pytest.fixture(scope='module')
def jax_run():
    """erd_tpu's ERD step: losses and gradients at the start, then three
    optax SGD steps (torch order, stem + layer1 frozen)."""
    jdet = JERDDetector(num_classes=NUM_CLASSES, depth=18,
                        erd=JERDConfig(ori_num_classes=ORI))
    jdet.net = jax_net(NUM_CLASSES)
    jdet.teacher.net = jax_net(ORI)
    teacher = perturb(to_numpy(jdet.teacher.init(jax.random.PRNGKey(1),
                                                 image_shape=SHAPE)),
                      np.random.RandomState(1))
    # init_student_from_teacher, step by step
    fresh = to_numpy(jdet.init(jax.random.PRNGKey(2), image_shape=SHAPE))
    widened = to_numpy(j_widen_cls_head(teacher, fresh, ORI))
    # a student diverged from its teacher (norms, biases, scales), so that
    # both distillation terms are live
    student = perturb(widened, np.random.RandomState(2))
    images, gt, meta = numpy_batch()
    batch = dict(images=jnp.asarray(images),
                 gt=JGTInstances(**{k: jnp.asarray(v)
                                    for k, v in gt.items()}),
                 meta=JImageMeta(**{k: jnp.asarray(v)
                                    for k, v in meta.items()}))
    consts = {k: v for k, v in student.items() if k != 'params'}
    tx = j_sgd_optimizer(lambda c: LR, momentum=0.9, weight_decay=1e-4,
                         frozen_stages=1)

    @jax.jit
    def step(params, state):
        def total(p):
            losses = jdet.loss({'params': p, **consts}, batch,
                               teacher_variables=teacher)
            return sum(losses.values()), losses
        (_, losses), grads = jax.value_and_grad(total, has_aux=True)(params)
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state, losses, grads

    params = student['params']
    state = tx.init(params)
    out = dict(teacher=teacher, fresh=fresh, widened=widened,
               student=student)
    for i in range(STEPS):
        params, state, losses, grads = step(params, state)
        if i == 0:
            out['losses'] = {k: float(v) for k, v in losses.items()}
            out['grads'] = to_numpy({'params': grads})
    out['final'] = to_numpy({'params': params, **consts})
    return out


def port_detector():
    return ERDDetector(num_classes=NUM_CLASSES, depth=18,
                       erd=ERDConfig(ori_num_classes=ORI))


def test_erd_loss_and_student_grads_match_jax(jax_run):
    det = port_detector()
    teacher = port_net(ORI, jax_run['teacher']).requires_grad_(False)
    student = port_net(NUM_CLASSES, jax_run['student'])
    losses = det.loss(student, port_batch(), teacher=teacher)
    assert set(losses) == set(jax_run['losses'])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), jax_run['losses'][k],
                                   rtol=1e-4, err_msg=k)
    assert losses['loss_dist_cls'] > 0 and losses['loss_dist_bbox'] > 0
    sum(losses.values()).backward()
    want = params_from_jax(jax_run['grads'])
    frozen = resnet_frozen_paths(1)
    for name, p in student.named_parameters():
        w = want[name].numpy()
        if name.startswith(frozen):
            assert p.grad is None and not p.requires_grad
            assert np.abs(w).max() == 0, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert all(p.grad is None for p in teacher.parameters())


class OneBatchLoader:
    """erd_tpu's loader protocol over one batch repeated ``steps`` times."""

    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps
        self.cfg = SimpleNamespace(batch_size=batch['images'].shape[0])

    def steps_per_epoch(self, epoch):
        return self.steps

    def epoch(self, epoch):
        for _ in range(self.steps):
            yield self.batch


class Recorder(Hook):

    def __init__(self):
        self.calls, self.losses = [], []

    def before_train(self, trainer):
        self.calls.append('before_train')

    def before_epoch(self, trainer, epoch):
        self.calls.append(f'before_epoch {epoch}')

    def after_iter(self, trainer, step, losses):
        self.calls.append(f'after_iter {step}')
        self.losses.append(losses)

    def after_epoch(self, trainer, epoch):
        self.calls.append(f'after_epoch {epoch}')


def test_three_sgd_steps_match_jax(jax_run):
    """Trainer.fit over the same batch three times against erd_tpu's optax
    step: parameters rtol 1e-4 with atol 1e-4 * max|p| of each tensor (an
    update carries its gradient's 1e-3 relative error), frozen stages and
    the teacher unchanged."""
    teacher = port_net(ORI, jax_run['teacher']).requires_grad_(False)
    student = port_net(NUM_CLASSES, jax_run['student'])
    start = copy.deepcopy(student.state_dict())
    teacher_start = copy.deepcopy(teacher.state_dict())
    rec = Recorder()
    # constant lr: no warmup, no auto-scaling at this batch size
    cfg = TrainerConfig(epochs=1, base_lr=LR, warmup_iters=1,
                        warmup_factor=1.0, auto_scale_base_batch=2)
    trainer = Trainer(port_detector(), OneBatchLoader(port_batch(), STEPS),
                      cfg, teacher=teacher, hooks=[rec], device='cpu')
    out = trainer.fit(student)
    assert out is student
    np.testing.assert_allclose(rec.losses[0]['loss_cls'],
                               jax_run['losses']['loss_cls'], rtol=1e-4)
    want = params_from_jax(jax_run['final'])
    frozen = resnet_frozen_paths(1)
    for name, value in student.state_dict().items():
        w = want[name].numpy()
        np.testing.assert_allclose(value.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
        if name.startswith(frozen) or 'running_' in name:
            assert torch.equal(value, start[name]), name
    for name, value in teacher.state_dict().items():
        assert torch.equal(value, teacher_start[name]), name


def test_fit_two_steps_from_the_erd_config():
    """build_trainer + fit of the ERD config (ResNet-18, full head width)
    for two steps: hooks fire in order, the stem, layer1 and the teacher
    stay as they were, every other parameter moves."""
    cfg = small_cfg(Config)
    cfg.train_cfg.epochs = 1
    # no warmup and a large lr, so every update shows in float32
    cfg.optim.update(lr=0.16, warmup_factor=1.0)
    det = build_detector(cfg.model)
    teacher = det.init_teacher(seed=1, device='cpu')
    student = det.init_student_from_teacher(2, teacher, device='cpu')
    start = copy.deepcopy(student.state_dict())
    teacher_start = copy.deepcopy(teacher.state_dict())
    rec = Recorder()
    trainer = build_trainer(cfg, det, OneBatchLoader(port_batch(), 2),
                            teacher=teacher, device='cpu')
    trainer.hooks.append(rec)
    trainer.fit(student)
    assert rec.calls == ['before_train', 'before_epoch 0', 'after_iter 0',
                         'after_iter 1', 'after_epoch 0']
    assert trainer.current_lr(0) == pytest.approx(0.16 * 2 / 16)
    for losses in rec.losses:
        assert set(losses) == {'loss_cls', 'loss_bbox', 'loss_dfl',
                               'loss_dist_cls', 'loss_dist_bbox'}
        assert all(np.isfinite(v) for v in losses.values())
    frozen = resnet_frozen_paths(1)
    trainable = {n for n, p in student.named_parameters() if p.requires_grad}
    for name, value in student.state_dict().items():
        moved = not torch.equal(value, start[name])
        assert moved == (name in trainable), name
        assert not (name.startswith(frozen) and moved), name
    for name, value in teacher.state_dict().items():
        assert torch.equal(value, teacher_start[name]), name


def test_distill_zero_when_student_is_teacher():
    """erd_tpu's test_erd invariant: a student widened from its teacher
    matches it on the old classes, so both distillation terms vanish."""
    det = ERDDetector(num_classes=6, depth=18,
                      erd=ERDConfig(ori_num_classes=3))
    teacher = det.init_teacher(seed=1, device='cpu')
    student = det.init_student_from_teacher(2, teacher, device='cpu')
    images = port_batch()['images']
    t_cls, t_reg = det.teacher.forward_raw(teacher, images)
    s_cls, s_reg = det.forward_raw(student, images)
    for tc, sc in zip(t_cls, s_cls):
        assert torch.equal(sc[..., :3], tc)
    for tr, sr in zip(t_reg, s_reg):
        assert torch.equal(sr, tr)
    losses = det.loss(student, port_batch(), teacher=teacher)
    assert losses['loss_dist_cls'].item() < 1e-8
    assert losses['loss_dist_bbox'].item() < 1e-6
    assert losses['loss_cls'].item() > 0


def test_widen_cls_head_matches_jax(jax_run):
    want = params_from_jax(jax_run['widened'])
    got = widen_cls_head(params_from_jax(jax_run['teacher']),
                         params_from_jax(jax_run['fresh']), ORI)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    fresh = params_from_jax(jax_run['fresh'])['bbox_head.gfl_cls.bias']
    assert torch.equal(got['bbox_head.gfl_cls.bias'][ORI:], fresh[ORI:])


def test_sgd_matches_torch_and_optax():
    """erd_tpu's test_engine SGD check, and the port's optimizer against
    erd_tpu's optax chain (torch order: decay, momentum, lr)."""
    rs = np.random.RandomState(0)
    w0 = rs.randn(4, 3).astype(np.float32)
    tx = j_sgd_optimizer(lambda c: 0.1, momentum=0.9, weight_decay=1e-2,
                         frozen_stages=-1)
    params = {'w': jnp.asarray(w0)}
    state = tx.init(params)
    net = torch.nn.Module()
    net.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = sgd_optimizer(net, 0.1, momentum=0.9, weight_decay=1e-2)
    for _ in range(5):
        g = rs.randn(4, 3).astype(np.float32)
        upd, state = tx.update({'w': jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        net.w.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(net.w.detach().numpy(),
                               np.asarray(params['w']), rtol=1e-5, atol=1e-6)


def test_frozen_stages_leave_the_optimizer():
    """The network owns the frozen stages; the optimizer takes exactly the
    parameters that still require a gradient."""
    assert all(p.requires_grad for p in GFLNet(
        NUM_CLASSES, depth=18, neck_out=64, stacked_convs=2).parameters())
    net = GFLNet(NUM_CLASSES, depth=18, neck_out=64, stacked_convs=2,
                 frozen_stages=1)
    opt = sgd_optimizer(net, 0.01)
    in_opt = {id(p) for g in opt.param_groups for p in g['params']}
    assert resnet_frozen_paths(1) == ('backbone.conv1.', 'backbone.bn1.',
                                      'backbone.layer1.')
    for name, p in net.named_parameters():
        frozen = name.startswith(('backbone.conv1.', 'backbone.bn1.',
                                  'backbone.layer1.'))
        assert p.requires_grad != frozen and (id(p) in in_opt) != frozen
    assert GFLDetector(depth=18).build_net().backbone.layer2[0].conv1 \
        .weight.requires_grad


def test_training_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    det = build_detector(small_cfg(Config).model)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        det.init(seed=0)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_trainer(small_cfg(Config), det,
                      OneBatchLoader(port_batch(), 1))
