"""Training parity of the port against the JAX package on the CPU: the
learning-rate schedules against ``gaot_tpu.train.schedules.make_schedule``,
and six AdamW steps with the 'mix' schedule (``train_step``) against optax's
AdamW from ``gaot_tpu.train.schedules.make_optimizer``, from the same
carried weights and the same batches.

The schedule is set so that the learning rate changes within the six steps
(two steps per epoch: warmup epoch, then the cosine phase from max_lr), so
reading the schedule one step late fails. Tolerance rtol 2e-4 on the loss of
every step and on the final weights (fp32 throughout), as the JAX package
reached against the original PyTorch GAOT.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp

OPT = {"name": "adamw",
       "args": {"lr": 1e-4, "max_lr": 1e-3, "min_lr": 1e-5, "final_lr": 1e-6,
                "weight_decay": 1e-3, "epoch": 10, "scheduler": "mix"}}
STEPS, STEPS_PER_EPOCH = 6, 2


@pytest.mark.parametrize("opt", [
    {"name": "adamw", "args": {"scheduler": "mix", "epoch": 60}},
    {"name": "adam", "args": {"scheduler": "mix", "epoch": 60}},
    {"name": "adamw", "args": {"scheduler": "mix", "epoch": 3}},
    {"name": "adamw", "args": {"scheduler": "step", "scheduler_step_size": 3}},
    {"name": "adamw", "args": {"scheduler": "cos", "scheduler_T_max": 7}},
    {"name": "adam", "args": {"scheduler": "exp", "scheduler_gamma": 0.7}},
    {"name": "adamw", "args": {"scheduler": "none"}},
], ids=["mix-adamw", "mix-adam", "mix-short", "step", "cos", "exp", "constant"])
def test_schedules_match(opt):
    from gaot_torch.core.config import OptimizerConfig, merge_config
    from gaot_torch.train.schedules import make_schedule
    from gaot_tpu.core.config import OptimizerConfig as JOptimizerConfig
    from gaot_tpu.core.config import merge_config as jmerge
    from gaot_tpu.train.schedules import make_schedule as jmake_schedule

    got = make_schedule(merge_config(OptimizerConfig, opt), 3)
    want = jmake_schedule(jmerge(JOptimizerConfig, opt), 3)
    steps = np.arange(200)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               np.asarray(jax.vmap(want)(jnp.asarray(steps))),
                               rtol=1e-5, atol=1e-12)


def _batches():
    rng = np.random.default_rng(21)
    return [(rng.normal(size=(tp.BATCH, tp.NUM_NODES, tp.IN_CH)).astype(np.float32),
             rng.normal(size=(tp.BATCH, tp.NUM_NODES, tp.OUT_CH)).astype(np.float32))
            for _ in range(STEPS)]


def _jax_run(batches, use_transpose_backward=True):
    from gaot_torch.utils.torch_interop import flax_to_torch_state_dict
    from gaot_tpu.core.config import OptimizerConfig as JOptimizerConfig
    from gaot_tpu.core.config import merge_config as jmerge
    from gaot_tpu.models import GAOT as JGAOT
    from gaot_tpu.train.schedules import make_optimizer
    from gaot_tpu.train.static_trainer import masked_mse

    coords, lat, _, _ = tp.workload()
    jcfg, _ = tp.configs()
    jcfg.args.magno.use_transpose_backward = use_transpose_backward
    enc, dec, enc_t, dec_t = tp.jax_graphs(coords, lat, jcfg)
    model = JGAOT(input_size=tp.IN_CH, output_size=tp.OUT_CH, config=jcfg)
    tx, _ = make_optimizer(jmerge(JOptimizerConfig, OPT), STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, tp.jax_params())
    state = tx.init(params)
    smask = jnp.ones(tp.BATCH, bool)

    @jax.jit
    def step(params, state, pndata, target):
        def loss_fn(p):
            pred = model.apply(p, jnp.asarray(lat), jnp.asarray(coords), pndata,
                               enc, dec, encoder_tgraphs=enc_t,
                               decoder_tgraphs=dec_t)
            return masked_mse(pred, target, smask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for pndata, target in batches:
        params, state, loss = step(params, state, jnp.asarray(pndata),
                                   jnp.asarray(target))
        losses.append(float(loss))
    return losses, flax_to_torch_state_dict(jax.tree.map(np.asarray, params))


def test_adamw_mix_steps_match_optax():
    from gaot_torch.core.config import OptimizerConfig, merge_config
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import FxGraphs, train_step

    batches = _batches()
    want_losses, want = _jax_run(batches)
    coords, lat, _, _ = tp.workload()
    _, tcfg = tp.configs()
    graphs = FxGraphs(torch.from_numpy(lat), *tp.torch_graphs(coords, lat, tcfg))
    model = tp.torch_model()
    opt, schedule = make_optimizer(merge_config(OptimizerConfig, OPT),
                                   model.parameters(), STEPS_PER_EPOCH)
    lrs = [schedule(s) for s in range(STEPS)]
    assert lrs[0] != lrs[2] != lrs[4]                 # the rate moves
    losses = [float(train_step(model, opt, schedule, s, graphs,
                               torch.from_numpy(coords), torch.from_numpy(pn),
                               torch.from_numpy(tg),
                               torch.ones(tp.BATCH, dtype=torch.bool)))
              for s, (pn, tg) in enumerate(batches)]
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        w = want[name].reshape(got[name].shape)
        np.testing.assert_allclose(got[name], w, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def test_train_step_refuses_attention_dropout():
    """Attention dropout is ported: the call that raised trains now, given
    a generator, on the plain attention with dropout (without one it raises,
    as the dropout draws from it); one seed gives one loss."""
    import copy

    from gaot_torch.core.config import ModelConfig, OptimizerConfig, merge_config
    from gaot_torch.models import GAOT
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import FxGraphs, train_step
    from gaot_torch.utils.routing import format_routes, reset_routes
    from gaot_torch.utils.torch_interop import load_flax_params

    cfg = copy.deepcopy(tp.MODEL_CFG)
    cfg["args"]["transformer"]["attn_config"]["atten_dropout"] = 0.1
    tcfg = merge_config(ModelConfig, cfg)
    coords, lat, pn, tg = tp.workload()
    graphs = FxGraphs(torch.from_numpy(lat), *tp.torch_graphs(coords, lat, tcfg))
    batch = (graphs, torch.from_numpy(coords), torch.from_numpy(pn),
             torch.from_numpy(tg), torch.ones(tp.BATCH, dtype=torch.bool))
    losses = []
    for seed in (0, 0, 1):
        model = GAOT(tp.IN_CH, tp.OUT_CH, tcfg, device="cpu")
        load_flax_params(model, tp.jax_params())
        opt, schedule = make_optimizer(merge_config(OptimizerConfig, OPT),
                                       model.parameters(), 1)
        with pytest.raises(ValueError, match="generator"):
            train_step(model, opt, schedule, 0, *batch)
        reset_routes()
        losses.append(float(train_step(model, opt, schedule, 0, *batch,
                                       generator=torch.Generator().manual_seed(seed))))
        assert "attn=plain-dropout" in format_routes()
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]


def test_train_step_refuses_without_transpose_graphs():
    """Training without the transpose graphs (magno.use_transpose_backward
    false), which was refused, takes an AdamW 'mix' step whose d_f is a
    scatter (the encoder's buckets and the dense decoder, neither with a
    transpose graph), and matches optax's step on the JAX package's plain
    routes: the loss and the weights within rtol 2e-4."""
    from gaot_torch.core.config import OptimizerConfig, merge_config
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import FxGraphs, train_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    batches = _batches()[:1]
    want_losses, want = _jax_run(batches, use_transpose_backward=False)
    coords, lat, _, _ = tp.workload()
    _, tcfg = tp.configs()
    tcfg.args.magno.use_transpose_backward = False
    enc, dec, enc_t, dec_t = tp.torch_graphs(coords, lat, tcfg)
    assert enc_t is None and dec_t is None and enc[0].tgraph is None
    graphs = FxGraphs(torch.from_numpy(lat), enc, dec, enc_t, dec_t)
    model = tp.torch_model()
    opt, schedule = make_optimizer(merge_config(OptimizerConfig, OPT),
                                   model.parameters(), STEPS_PER_EPOCH)
    reset_routes()
    (pn, tg), = batches
    loss = float(train_step(model, opt, schedule, 0, graphs, torch.from_numpy(coords),
                            torch.from_numpy(pn), torch.from_numpy(tg),
                            torch.ones(tp.BATCH, dtype=torch.bool)))
    assert format_routes().startswith(
        "agno=bucketed:plain:scatter-df+dense:plain:scatter-df"), format_routes()
    np.testing.assert_allclose([loss], want_losses, rtol=2e-4)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        w = want[name].reshape(got[name].shape)
        np.testing.assert_allclose(got[name], w, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=name)
