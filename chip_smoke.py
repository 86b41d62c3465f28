"""Smoke run of the PyTorch/CUDA port (urban_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the two CUDA kernels from the sources in the checkout (one nvcc per
source, all at once) and checks each against its plain PyTorch version at
the shapes of the main paths: the forward segment mean, which every path
runs, and its backward, which the PPO update runs, each at the HLG
rollout's, the HLG trainer's, a large graph's, the grid trainer's and the
concept scenarios' size, timed beside one PyTorch library call and its
memory bound (urban_tpu_torch/kernel_bench.py). The backward must give the
plain version's bits, on the card and on the CPU.
Runs the SGNN policy on the card against the same model on the CPU, and
one PPO loss backward on the card against the CPU. Drives the batched HLG
rollout (256 envs x 30 steps), steps GPU and CPU environments in lockstep,
then runs one full HLG PPO train_iteration (256 envs x 50 steps, 4 epochs
of minibatch 256) and a 16-env greedy evaluation. Then the road and
concept rewards on the card against the CPU, a road-stage lockstep of the
grid scenario on the card against the CPU, and one full grid PPO
train_iteration with land use and roads (192 envs x 120 steps, 4 epochs of
minibatch 256), whose road head must learn. The MLP encoder (no message
passing, no kernel) runs on the card against the CPU, forward and one PPO
loss gradient. Then the grid's two-phase run_training (land use, the
freeze of the best greedy plan, roads) of one iteration a phase, its
resume from the phase-2 checkpoint, and both kernels at the frozen plan's
graph. The launch counts show that each path went through its kernels.
One line per phase; the line before the last is one JSON object describing
each kernel, the last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA device or any check
fails. About 11 minutes on an H100.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOL_KERNEL = 1e-5        # kernel vs plain segment mean (f32, other sum order)
TOL_MODEL = 1e-4         # policy logits / value, card vs CPU
STATE_RTOL, STATE_ATOL = 1e-5, 1e-4   # float state fields, as the CPU tests
# parameter gradients of one PPO loss, card vs CPU: max |difference| of a
# tensor <= TOL_GRAD_REL x its largest CPU gradient + TOL_GRAD_ABS. The
# relative part: f32 sums over up to B x E = 768,000 terms in other orders
# (cuBLAS vs the CPU's BLAS, the kernels vs index_add_), whose rounding
# grows like sqrt(n) x 6e-8, about 1e-4; 1e-3 leaves a margin. The
# absolute part: the attention key bias's gradient is zero in exact
# arithmetic (softmax ignores a shift common to all logits), so on both
# devices it is rounding noise far below 1e-6
TOL_GRAD_REL, TOL_GRAD_ABS = 1e-3, 1e-6
TOL_ROAD = 1e-6          # road reward, card vs CPU (f32 sums, other order)
ROLLOUT_STEPS, TRAIN_ENVS, TRAIN_LEN, EVAL_ENVS = 30, 256, 50, 16
# the grid trainer's own batch and window (urban_tpu/cfg grid.yaml)
GRID_ENVS, GRID_LEN = 192, 120
ROAD_BATCH, ROAD_CPU_ENVS, CONCEPT_BATCH, ROAD_LOCKSTEP_ENVS = 32, 32, 256, 8
# the grid's two-phase run: cfg.train() / cfg.finetune() halve the episode
# cap to 60 steps, which holds a land-use episode (about 48 steps) and a
# road one; the rollout is host-bound whatever the batch, so the envs are
# few, and one greedy eval env is enough (every greedy episode from the
# initial state is the same)
TWO_PHASE_SEED, TWO_PHASE_ENVS, TWO_PHASE_EVAL_ENVS, TWO_PHASE_LEN = 0, 8, 1, 60


def phase(name, t0, **kv):
    print(json.dumps({'phase': name, 'seconds': round(time.time() - t0, 3),
                      **kv}), flush=True)


def check_kernels(kb, segment_ops, dev, real_obs, t0, shapes=None,
                  random_graphs=True):
    """Phase 3: the forward and the backward kernel against their plain
    versions at every shape of `shapes` (kb.SHAPES), timed on random
    graphs (unless random_graphs is False), and on a scenario's real graph
    where real_obs has one for the shape. Returns the times by shape and
    the largest errors; the inputs, some of them GB, are freed on return,
    before the paths whose memory is measured."""
    B = kb.B
    rng = np.random.default_rng(0)
    fwd, bwd, fwd_err, bwd_err = {}, {}, 0.0, 0.0
    for shape, e, n, d in shapes or kb.SHAPES:
        graphs = {}
        if random_graphs:
            graphs['random_bipartite_30pct_masked'] = kb.random_graph(
                rng, B, e, n)
        if shape in real_obs:
            gname, o = real_obs[shape]
            if tuple(o[2].shape[1:2]) + tuple(o[4].shape[1:2]) != (e, n):
                raise AssertionError(f'{shape}: {gname} graph is not '
                                     f'{(e, n)}')
            graphs[gname] = (o[2].expand(B, -1, -1).contiguous(),
                             o[5].expand(B, -1).contiguous())
        for gname, (edges, mask) in graphs.items():
            timed = gname.startswith('random_bipartite')
            h = torch.where(mask[..., None], torch.as_tensor(
                rng.normal(size=(B, e, d)), dtype=torch.float32), 0.0)
            cpu_out, cpu_counts = segment_ops.segment_mean_counts_ref(
                h, edges, mask, n)
            edges_cpu, mask_cpu = edges, mask
            h, edges, mask = h.to(dev), edges.to(dev), mask.to(dev)
            out, counts = segment_ops.segment_mean_counts(h, edges, mask, n)
            again, counts2 = segment_ops.segment_mean_counts(h, edges, mask,
                                                             n)
            with torch.no_grad():   # rollout, collect and eval
                no_grad = segment_ops.segment_mean(h, edges, mask, n)
            ref = segment_ops.segment_mean_ref(h, edges, mask, n)
            torch.cuda.synchronize()
            if not (torch.equal(out, again) and torch.equal(counts, counts2)
                    and torch.equal(out, no_grad)):
                raise AssertionError(f'{shape} {gname}: launches differ')
            if not torch.equal(counts.cpu(), cpu_counts):
                raise AssertionError(f'{shape} {gname}: counts differ')
            err = float((out - ref).abs().max())
            if not err <= TOL_KERNEL:
                raise AssertionError(f'{shape} {gname}: kernel vs plain '
                                     f'{err} > {TOL_KERNEL}')
            # on a bipartite graph the CPU plain version adds each node's
            # rows in edge order, as the kernel does; on a scenario's graph
            # some nodes are both first and second endpoints, and its two
            # index_add_ passes add them in another order
            same_bits = torch.equal(out.cpu(), cpu_out)
            if timed and not same_bits:
                raise AssertionError(f'{shape} {gname}: not the CPU plain '
                                     f'version\'s bits')
            fwd_err = max(fwd_err, err)
            times = {}
            if timed:
                lib, lib_out = kb.library_forward(h, edges, mask, n)
                lib_err = float((lib_out - ref).abs().max())
                if not lib_err <= TOL_KERNEL:
                    raise AssertionError(f'{shape}: library forward {lib_err}')
                def kernel():
                    return segment_ops.segment_mean_counts(h, edges, mask, n)
                times = fwd[shape] = {
                    'ms': kb.cuda_time_ms(kernel),
                    'device_ms': kb.device_time_ms(kernel),
                    'plain_ms': kb.cuda_time_ms(
                        lambda: segment_ops.segment_mean_counts_ref(
                            h, edges, mask, n)),
                    'library_ms': kb.cuda_time_ms(lib),
                    'bound_ms': kb.bound_ms(kb.forward_bytes(edges, mask, n,
                                                             d))}
            phase('segment_mean_vs_plain', t0, shape=shape, graph=gname,
                  BEND=[B, e, n, d], segment_mean_fits=bool(
                      segment_ops.load_library('segment_mean')
                      .segment_mean_fits(n, e)),
                  max_abs_err=err, bitwise_repeat=True,
                  counts_equal=True, same_bits_as_cpu_plain=same_bits,
                  **times)
            # the backward, bit for bit: (0 + s_u) + s_v with one IEEE
            # division per scaled row, on the card as on the CPU
            g_cpu = torch.as_tensor(rng.normal(size=(B, n, d)),
                                    dtype=torch.float32)
            cpu_dh = segment_ops.segment_mean_backward_ref(
                g_cpu, cpu_counts, edges_cpu, mask_cpu)
            g = g_cpu.to(dev)
            dh = segment_ops.segment_mean_backward(g, counts, edges, mask)
            dh2 = segment_ops.segment_mean_backward(g, counts, edges, mask)
            dref = segment_ops.segment_mean_backward_ref(g, counts, edges,
                                                         mask)
            torch.cuda.synchronize()
            err = float((dh - dref).abs().max())
            checks = {'bitwise_repeat': torch.equal(dh, dh2),
                      'equal_to_plain': torch.equal(dh, dref),
                      'equal_to_cpu_plain': torch.equal(dh.cpu(), cpu_dh)}
            if not all(checks.values()):
                raise AssertionError(f'{shape} {gname}: backward {checks}, '
                                     f'max abs error {err}')
            bwd_err = max(bwd_err, err)
            times = {}
            if timed:
                lib, lib_dh = kb.library_backward(g, counts, edges, mask)
                lib_err = float((lib_dh - dref).abs().max())
                if not lib_err <= TOL_KERNEL:
                    raise AssertionError(f'{shape}: library backward '
                                         f'{lib_err}')
                def kernel():
                    return segment_ops.segment_mean_backward(g, counts, edges,
                                                             mask)
                times = bwd[shape] = {
                    'ms': kb.cuda_time_ms(kernel),
                    'device_ms': kb.device_time_ms(kernel),
                    'plain_ms': kb.cuda_time_ms(
                        lambda: segment_ops.segment_mean_backward_ref(
                            g, counts, edges, mask)),
                    'library_ms': kb.cuda_time_ms(lib),
                    'bound_ms': kb.bound_ms(kb.backward_bytes(
                        edges, mask, counts, d))}
            phase('segment_mean_backward_vs_plain', t0, shape=shape,
                  graph=gname, BEND=[B, e, n, d],
                  plan=segment_ops.backward_plan(n, d)._asdict(),
                  max_abs_err=err, **checks, **times)
    return fwd, bwd, fwd_err, bwd_err


def ppo_grads_card_vs_cpu(m_gpu, m_cpu, obs, actions, log_probs, dev):
    """One PPO loss backward of the same minibatch (obs, actions, and
    seeded returns, advantages, weights and old log-probs near log_probs)
    on the card and on the CPU, each parameter's gradient within
    TOL_GRAD_REL x its largest CPU gradient + TOL_GRAD_ABS. Returns (error
    by parameter, bound by parameter, the card's gradients)."""
    from urban_tpu_torch.rl.ppo import PPOConfig, ppo_loss
    B = actions.shape[0]
    grng = np.random.default_rng(3)
    returns, adv, noise = (torch.as_tensor(grng.normal(size=(B, 1)),
                                           dtype=torch.float32)
                           for _ in range(3))
    exps = torch.as_tensor(grng.random(B) < 0.7, dtype=torch.float32)
    valid = torch.as_tensor(grng.random(B) < 0.8, dtype=torch.float32)
    fixed = log_probs[:, None].cpu() + 0.3 * noise
    grads = {}
    for where, model, d in (('card', m_gpu, dev), ('cpu', m_cpu, 'cpu')):
        loss, _ = ppo_loss(model, tuple(o.to(d) for o in obs),
                           actions.to(d), returns.to(d), adv.to(d),
                           fixed.to(d), exps.to(d), PPOConfig(), valid.to(d))
        loss.backward()
        grads[where] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    err = {k: float((grads['card'][k] - g).abs().max())
           for k, g in grads['cpu'].items()}
    bound = {k: TOL_GRAD_REL * float(g.abs().max()) + TOL_GRAD_ABS
             for k, g in grads['cpu'].items()}
    bad = {k: (e, bound[k]) for k, e in err.items() if not e <= bound[k]}
    if bad:
        raise AssertionError(f'PPO gradients card vs cpu: {bad}')
    return err, bound, grads['card']


def lockstep(spec, s_cpu, s_gpu, n_steps, choose):
    """Steps the CPU states s_cpu and the card states s_gpu n_steps times
    through the batched step with the same actions, choose(observation on
    the CPU) -> (B, 2) int32; each step the observation's edges and masks,
    the failure code, every state field and the reward must agree (ints
    and bools equal, floats within STATE_RTOL / STATE_ATOL). Returns
    (agreeing steps, per-step info on the CPU, per-step rewards)."""
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                                  make_batch_fns)
    batch_obs, batch_step = make_batch_fns(spec)
    dev = s_gpu.stage.device
    infos, rewards = [], []
    for step in range(n_steps):
        o_cpu = batch_obs(s_cpu)
        o_gpu = batch_obs(s_gpu)
        for k in (2, 4, 5, 6, 7):
            if not torch.equal(o_cpu[k], o_gpu[k].cpu()):
                raise AssertionError(f'step {step}: observation {k} differs')
        a = torch.as_tensor(choose(o_cpu))
        n_cpu, r_cpu, _, i_cpu = batch_step(s_cpu, a)
        n_cpu, r_cpu = apply_stage_rewards(spec, n_cpu, r_cpu, i_cpu)
        n_gpu, r_gpu, _, i_gpu = batch_step(s_gpu, a.to(dev))
        n_gpu, r_gpu = apply_stage_rewards(spec, n_gpu, r_gpu, i_gpu)
        if not torch.equal(i_cpu['failure_code'], i_gpu['failure_code'].cpu()):
            raise AssertionError(f'step {step}: failure_code differs')
        for name in tstate.FIELD_NAMES:
            x, y = getattr(n_cpu, name), getattr(n_gpu, name).cpu()
            if x.dtype.is_floating_point:
                ok = torch.allclose(y, x, rtol=STATE_RTOL, atol=STATE_ATOL)
            else:
                ok = torch.equal(x, y)
            if not ok:
                raise AssertionError(f'step {step}: field {name} differs')
        if not torch.allclose(r_gpu.cpu(), r_cpu, rtol=STATE_RTOL,
                              atol=STATE_ATOL):
            raise AssertionError(f'step {step}: reward differs')
        infos.append(i_cpu)
        rewards.append(r_cpu)
        s_cpu, s_gpu = n_cpu, n_gpu
    return n_steps, infos, rewards


def compare_road_reward(spec, states_cpu, dev, what):
    """batched_road_network_reward on the card against the CPU on the same
    states: its integer terms equal, the reward within TOL_ROAD. Returns
    (summary, the CPU's rewards)."""
    from urban_tpu_torch.torchenv.step import batched_road_network_reward
    r_cpu, c_cpu = batched_road_network_reward(spec, states_cpu,
                                               with_counts=True)
    states = states_cpu.map(lambda x: x.to(dev))
    torch.cuda.synchronize()
    t = time.time()
    r_gpu, c_gpu = batched_road_network_reward(spec, states,
                                               with_counts=True)
    torch.cuda.synchronize()
    card_s = time.time() - t
    for k, v in c_cpu.items():
        if not torch.equal(v, c_gpu[k].cpu()):
            raise AssertionError(f'road reward {what}: {k} differ: card '
                                 f'{c_gpu[k].tolist()} cpu {v.tolist()}')
    err = float((r_gpu.cpu() - r_cpu).abs().max())
    if not err <= TOL_ROAD:
        raise AssertionError(f'road reward {what}: card vs cpu {err}')
    return {'states': what, 'batch': int(r_cpu.shape[0]),
            'max_abs_err': err, 'tolerance': TOL_ROAD,
            'card_seconds': card_s,
            'reward_range': [float(r_cpu.min()), float(r_cpu.max())],
            'count_ranges': {k: [int(v.min()), int(v.max())]
                             for k, v in c_cpu.items()}}, r_cpu


def compare_concept_reward(spec, init_cpu, dev, chunk=64):
    """concept_reward and land_use_stage_reward, vmapped as the rollout
    calls them, on CONCEPT_BATCH plans (the initial one and seeded random
    land uses on its alive polygons), on the card against the CPU within
    STATE_RTOL / STATE_ATOL."""
    from torch.func import vmap
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv.step import (concept_reward,
                                               land_use_stage_reward)
    fields = tstate.plan_state_to_numpy(init_cpu)
    alive = np.nonzero(fields['poly_alive'])[0]
    rng = np.random.default_rng(13)
    batch = {k: np.repeat(v[None], CONCEPT_BATCH, 0)
             for k, v in fields.items()}
    batch['poly_type'][1:, alive] = rng.choice(
        [4, 4, 4, 5, 6, 7, 8, 9, 10, 11, 12], (CONCEPT_BATCH - 1, len(alive)))
    states = tstate.plan_state_from_numpy(batch, 'cpu')
    out = {}
    for name, fn in (('concept', concept_reward),
                     ('land_use_stage', land_use_stage_reward)):
        f = vmap(lambda s: fn(spec, s))
        parts = [(f(states.map(lambda x: x[i:i + chunk])),
                  f(states.map(lambda x: x[i:i + chunk].to(dev))).cpu())
                 for i in range(0, CONCEPT_BATCH, chunk)]
        cpu = torch.cat([p[0] for p in parts])
        card = torch.cat([p[1] for p in parts])
        if not torch.allclose(card, cpu, rtol=STATE_RTOL, atol=STATE_ATOL):
            raise AssertionError(f'{name} reward card vs cpu: '
                                 f'{float((card - cpu).abs().max())}')
        out[name] = {'max_abs_err': float((card - cpu).abs().max()),
                     'range': [float(cpu.min()), float(cpu.max())]}
    if not out['concept']['range'][1] > 0:
        raise AssertionError('concept reward is zero on every plan')
    return out


def road_lockstep(spec, init_np, dev):
    """ROAD_LOCKSTEP_ENVS grid envs at the start of their road stage
    (road_fixtures.road_stage_state, seeds 0-7) stepped through every road
    step on the card and on the CPU with the same road actions, drawn
    from the CPU's road mask; every env must finish its road stage once,
    without failure, with a road reward in (0, 1]."""
    from urban_tpu_torch.torchenv import road_fixtures
    from urban_tpu_torch.torchenv import state as tstate
    states = [road_fixtures.road_stage_state(init_np, spec.road_ratio, seed)
              for seed in range(ROAD_LOCKSTEP_ENVS)]
    batch = {k: np.stack([x[k] for x in states]) for k in init_np}
    budget = batch['total_road_steps']
    s_cpu = tstate.plan_state_from_numpy(batch, 'cpu')
    arng = np.random.default_rng(17)

    def choose(o):
        return np.array([[0, int(arng.choice(np.nonzero(rd)[0]))
                          if rd.any() else 0] for rd in o[7].numpy()],
                        dtype=np.int32)
    n, infos, rewards = lockstep(spec, s_cpu, s_cpu.map(lambda x: x.to(dev)),
                                 int(budget.max()), choose)
    rd_done = torch.stack([i['rd_done'] for i in infos]).numpy()
    failure = torch.stack([i['failure'] for i in infos]).numpy()
    first = rd_done.argmax(0)
    final = torch.stack(rewards).numpy()[first, np.arange(len(first))]
    if not (rd_done.sum(0) == 1).all() or (first + 1 != budget).any() \
            or failure[rd_done].any() or not ((final > 0)
                                              & (final <= 1)).all():
        raise AssertionError(f'road stage: rd_done at {first.tolist()}, '
                             f'budgets {budget.tolist()}, rewards '
                             f'{final.tolist()}')
    return {'steps': n, 'road_budgets': budget.tolist(),
            'road_rewards': final.tolist()}


def two_phase_grid(dev, layers):
    """The grid's two-phase run_training on the card: TWO_PHASE_ENVS envs
    x TWO_PHASE_LEN steps, one iteration of land use (skip_road with
    keep_boundaries), the freeze of the best greedy plan with a warm start,
    one iteration of roads. Each collect, update and eval of each phase is
    counted on its own: rollout_len x layers segment means for a collect
    and for an eval, minibatch steps x layers forward and backward for an
    update. Every parameter must move in phase 2 but the land-use head's,
    whose gradient is exactly zero in a road-only phase (as the road
    head's is on HLG); the road rewards lie in (0, 1]. Then run_training
    resumes the phase-2 checkpoint, which must rebuild the same spec and
    the same parameters. Returns the phase's record."""
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl import trainer as trainer_mod
    from urban_tpu_torch.torchenv.step import road_mask
    T = trainer_mod.Trainer
    counted, stats, rec = [], {}, {}
    orig = {n: getattr(T, n) for n in ('collect', 'update', 'eval_agent',
                                       'train_iteration')}
    orig_freeze = trainer_mod.freeze_land_use_trainer

    def counting(name):
        def wrapper(self, *a, **k):
            segment_ops.reset_launches()
            t = time.time()
            out = orig[name](self, *a, **k)
            torch.cuda.synchronize()
            counted.append({'phase': self.phase, 'part': name,
                            'seconds': time.time() - t,
                            'launches': dict(segment_ops.launches)})
            if name == 'collect':
                ok = out.dones & ~out.failures
                rec.setdefault(f'rewards_{self.phase}', []).append(
                    out.rewards[ok].cpu())
            if name == 'eval_agent':
                rec[f'eval_{self.phase}'] = out
            return out
        return wrapper

    def iteration(self, it, do_eval=True):
        st = orig['train_iteration'](self, it, do_eval)
        stats[self.phase] = {
            't_sample_s': st.sample_time, 't_update_s': st.update_time,
            'episodes': st.episodes, 'failures': st.failures,
            'failure_causes': st.failure_causes,
            'mean_episode_reward': st.mean_episode_reward,
            'eval_reward': st.eval_reward,
            'graph': [self.spec.NE, self.spec.num_features],
            'caps': {k: getattr(self.spec, k)
                     for k in ('NP', 'NS', 'NPT', 'NE')}}
        return st

    def freeze(trainer, table, warm_start_params=None):
        rec['phase1_spec'] = {'skip_road': trainer.spec.skip_road,
                              'keep_boundaries': trainer.spec.keep_boundaries}
        rec['phase1_peak_bytes'] = torch.cuda.max_memory_allocated(dev)
        from urban_tpu_torch.host import city_config
        rec['frozen_boundaries'] = int(
            (table.alive_mask_of(city_config.BOUNDARY)).sum())
        out = orig_freeze(trainer, table, warm_start_params)
        # phase 1's model, optimizer and env batch are freed by now
        torch.cuda.reset_peak_memory_stats(dev)
        rec['road_mask'] = int(road_mask(trainer.spec,
                                         trainer.init_state).sum())
        rec['total_road_steps'] = int(trainer.init_state.total_road_steps)
        rec['warm_start'] = trainer.warm_start
        rec['before'] = {k: p.detach().clone()
                         for k, p in trainer.model.named_parameters()}
        return out

    with tempfile.TemporaryDirectory() as run_dir:
        for name in orig:
            setattr(T, name, iteration if name == 'train_iteration'
                    else counting(name))
        trainer_mod.freeze_land_use_trainer = freeze
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        try:
            trainer = trainer_mod.run_training(
                Config('grid', TWO_PHASE_SEED, root_dir=run_dir), 1,
                TWO_PHASE_ENVS, separate_train=True,
                eval_envs=TWO_PHASE_EVAL_ENVS, rollout_len=TWO_PHASE_LEN,
                device=dev)
        finally:
            for name, fn in orig.items():
                setattr(T, name, fn)
            trainer_mod.freeze_land_use_trainer = orig_freeze
        run_seconds = time.time() - t
        rec['phase2_peak_bytes'] = torch.cuda.max_memory_allocated(dev)
        final = os.path.join(trainer.cfg.model_dir, 'phase2_final.pt')
        if trainer.phase != 2 or not os.path.exists(final):
            raise AssertionError(f'phase 2 did not run: phase '
                                 f'{trainer.phase}, phase-1 eval '
                                 f'{rec.get("eval_1")}')
        if rec['phase1_spec'] != {'skip_road': True,
                                  'keep_boundaries': True}:
            raise AssertionError(f'phase 1 ran {rec["phase1_spec"]}')
        if not (rec['road_mask'] > 0 and rec['total_road_steps'] > 0
                and rec['frozen_boundaries'] > 0):
            raise AssertionError(f'the frozen plan has no road candidates: '
                                 f'{rec}')
        cfg = trainer.cfg
        n = TWO_PHASE_ENVS * TWO_PHASE_LEN
        mb_steps = cfg.num_optim_epoch * max(n // min(cfg.mini_batch_size,
                                                      n), 1)
        expect = {'collect': (TWO_PHASE_LEN * layers, 0),
                  'update': (mb_steps * layers, mb_steps * layers),
                  'eval_agent': (TWO_PHASE_LEN * layers, 0)}
        got = [(c['phase'], c['part'], (c['launches']['segment_mean'],
                                        c['launches']['segment_mean_backward']))
               for c in counted]
        want = [(ph, part, expect[part]) for ph in (1, 2)
                for part in ('collect', 'update', 'eval_agent')]
        if got != want:
            raise AssertionError(f'two-phase launches {got} != {want}')
        moved = {k: not torch.equal(p, rec['before'][k])
                 for k, p in trainer.model.named_parameters()}
        wrong = sorted(k for k, m in moved.items()
                       if m == k.startswith('land_use_head.'))
        if wrong or not any(m for k, m in moved.items()
                            if k.startswith('road_head.')):
            raise AssertionError(f'phase-2 parameters moved wrongly: {wrong}')
        copied, total = rec['warm_start']
        if not copied == total == len(moved):
            raise AssertionError(f'warm start {copied}/{total}')
        road = torch.cat(rec['rewards_2'])
        eval_2 = rec['eval_2'][0]
        if road.numel() < 1 or not bool(((road > 0) & (road <= 1)).all()) \
                or not 0 < eval_2 <= 1:
            raise AssertionError(f'phase-2 road rewards {road.tolist()}, '
                                 f'eval {eval_2}')
        spec2 = trainer.spec
        init2 = trainer.init_state.map(lambda x: x.cpu())
        params = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        del trainer
        # the resume from the phase-2 checkpoint, in another run directory
        t = time.time()
        with tempfile.TemporaryDirectory() as resume_dir:
            again = trainer_mod.run_training(
                Config('grid', TWO_PHASE_SEED, root_dir=resume_dir), 1,
                TWO_PHASE_ENVS, separate_train=True,
                eval_envs=TWO_PHASE_EVAL_ENVS, rollout_len=TWO_PHASE_LEN,
                resume=final, device=dev)
            same = (again.phase == 2 and again.start_iteration == 2
                    and dataclasses.asdict(again.spec)
                    == dataclasses.asdict(spec2)
                    and all(torch.equal(v, params[k]) for k, v
                            in again.model.state_dict().items()))
            del again
        if not same:
            raise AssertionError('the resume from phase2_final rebuilt '
                                 'another spec or other parameters')
        resume_seconds = time.time() - t
    rec.update(run_seconds=run_seconds, resume_seconds=resume_seconds,
               counted=counted, stats=stats, spec2=spec2, init2=init2,
               road_rewards=road, moved=moved)
    return rec


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port has no CPU '
                         'fallback for this check')

    from urban_tpu_torch import bench
    from urban_tpu_torch import kernel_bench as kb
    from urban_tpu_torch.models.policy import MASK_PAD
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.torchenv import road_fixtures
    from urban_tpu_torch.torchenv import rollout as rollout_mod
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv.rollout import (broadcast_state,
                                                  make_batch_fns, rollout)
    bench.set_precision_flags()
    dev = torch.device('cuda', 0)
    B = kb.B

    # ---- 1. device ------------------------------------------------------
    t0 = time.time()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else 'nvidia-smi: no output'
    phase('device', t0, torch=torch.__version__, cuda=torch.version.cuda,
          gpu=torch.cuda.get_device_name(0), nvidia_smi=smi_line)

    # ---- 2. build -------------------------------------------------------
    t0 = time.time()
    libs = segment_ops.build_libraries()
    for name in libs:
        segment_ops.load_library(name)
    root = os.path.dirname(os.path.abspath(__file__))
    phase('build', t0, nvcc_seconds=segment_ops.build_seconds,
          libraries={k: os.path.relpath(v, root) for k, v in libs.items()})

    # ---- 3. the kernels against their plain versions --------------------
    # the forward and the backward at every shape of kb.SHAPES, on a random
    # bipartite graph (timed) and on a scenario's initial observation: HLG
    # at the rollout's and the trainer's size, grid at its trainer's, and
    # hlg_concept at the concept trainer's
    t0 = time.time()
    cfg, spec, init_cpu = bench.setup('hlg', bench.BENCH_CAPS, 'cpu')
    obs0 = make_batch_fns(spec)[0](broadcast_state(init_cpu, 1))
    cfg_t, spec_t, init_t = bench.setup('hlg', {}, 'cpu')  # trainer caps
    N_T, E_T = spec_t.num_features, spec_t.NE
    obs_t = make_batch_fns(spec_t)[0](broadcast_state(init_t, 1))
    cfg_g, spec_g, init_g_cpu = bench.setup('grid', {}, 'cpu')  # trainer caps
    _, spec_c, init_c = bench.setup('hlg_concept', {}, 'cpu')
    real_obs = {
        'rollout': ('hlg_initial_observation', obs0),
        'trainer': ('hlg_initial_observation', obs_t),
        'grid_trainer': ('grid_initial_observation', make_batch_fns(
            spec_g)[0](broadcast_state(init_g_cpu, 1))),
        'concept': ('hlg_concept_initial_observation', make_batch_fns(
            spec_c)[0](broadcast_state(init_c, 1)))}
    fwd, bwd, fwd_err, bwd_err = check_kernels(kb, segment_ops, dev,
                                               real_obs, t0)

    # ---- 4. model on the card vs the CPU --------------------------------
    t0 = time.time()
    model_cpu = bench.make_model(cfg, spec, seed=0, device='cpu')
    model_gpu = bench.make_model(cfg, spec, seed=0, device=dev)
    obs8 = tuple(x.expand((8,) + x.shape[1:]).contiguous() for x in obs0)
    with torch.no_grad():
        lu_c, rd_c, _, v_c = model_cpu(obs8)
        lu_g, rd_g, _, v_g = model_gpu(tuple(x.to(dev) for x in obs8))
    lu_g, rd_g, v_g = lu_g.cpu(), rd_g.cpu(), v_g.cpu()
    lu_m, rd_m = obs8[6], obs8[7]
    errs = {'land_use_logits': float((lu_g - lu_c)[lu_m].abs().max()),
            'value': float((v_g - v_c).abs().max())}
    if rd_m.any():
        errs['road_logits'] = float((rd_g - rd_c)[rd_m].abs().max())
    pad_ok = bool((lu_g[~lu_m] == MASK_PAD).all()
                  and (rd_g[~rd_m] == MASK_PAD).all())
    if not (pad_ok and all(e <= TOL_MODEL for e in errs.values())):
        raise AssertionError(f'model card vs cpu: {errs}, pad_ok={pad_ok}')
    phase('model_card_vs_cpu', t0, max_abs_err=errs, masked_equal_pad=pad_ok,
          unmasked_land_use_actions=int(lu_m[0].sum()))

    # ---- 4b. one PPO loss backward on the card vs the CPU ---------------
    t0 = time.time()
    m_gpu = bench.make_model(cfg_t, spec_t, seed=1, device=dev)
    m_cpu = bench.make_model(cfg_t, spec_t, seed=1, device='cpu')
    init_g = init_t.map(lambda x: x.to(dev))
    _, traj = rollout(spec_t, m_gpu, init_g, broadcast_state(
        init_g.replace(done=torch.ones_like(init_g.done)), B),
        torch.Generator(device=dev).manual_seed(2), 2)
    obs_mb = tuple(o[1] for o in traj.obs)   # 256 HLG states, one step in
    err, bound, card_grads = ppo_grads_card_vs_cpu(
        m_gpu, m_cpu, obs_mb, traj.actions[1], traj.log_probs[1], dev)
    edge_fc = {k: float(g.abs().sum()) for k, g in card_grads.items()
               if '.edge_fc.' in k}
    if not all(s > 0 for s in edge_fc.values()):
        raise AssertionError(f'edge_fc gradient sums {edge_fc}')
    h_req = torch.zeros(2, E_T, 16, device=dev, requires_grad=True)
    agg = segment_ops.segment_mean(h_req, obs_mb[2][:2].to(dev),
                                   obs_mb[5][:2].to(dev), N_T)
    if agg.grad_fn is None:
        raise AssertionError('segment_mean on the card has no grad_fn')
    phase('model_grad_card_vs_cpu', t0, rows=B, parameters=len(err),
          max_abs_err=max(err.values()),
          max_err_over_bound=max(err[k] / bound[k] for k in err),
          tolerance=[TOL_GRAD_REL, TOL_GRAD_ABS],
          edge_fc_grad_abs_sums=edge_fc,
          segment_mean_grad_fn=type(agg.grad_fn).__name__)

    # ---- 4c. the MLP encoder on the card vs the CPU ---------------------
    # the ablation without message passing, at the grid's widths: logits
    # and value on 256 grid states one step in, then one PPO loss gradient;
    # it launches neither kernel
    t0 = time.time()
    segment_ops.reset_launches()
    mlp_gpu = bench.make_model(cfg_g, spec_g, seed=0, device=dev,
                               encoder='mlp')
    mlp_cpu = bench.make_model(cfg_g, spec_g, seed=0, device='cpu',
                               encoder='mlp')
    init_gg = init_g_cpu.map(lambda x: x.to(dev))
    _, traj = rollout(spec_g, mlp_gpu, init_gg, broadcast_state(
        init_gg.replace(done=torch.ones_like(init_gg.done)), B),
        torch.Generator(device=dev).manual_seed(4), 2)
    obs_mlp = tuple(o[1] for o in traj.obs)   # 256 grid states, one step in
    with torch.no_grad():
        lu_c, rd_c, _, v_c = mlp_cpu(tuple(o.cpu() for o in obs_mlp))
        lu_g, rd_g, _, v_g = mlp_gpu(obs_mlp)
    lu_g, rd_g, v_g = lu_g.cpu(), rd_g.cpu(), v_g.cpu()
    lu_m, rd_m = obs_mlp[6].cpu(), obs_mlp[7].cpu()
    errs = {'land_use_logits': float((lu_g - lu_c)[lu_m].abs().max()),
            'value': float((v_g - v_c).abs().max())}
    if rd_m.any():
        errs['road_logits'] = float((rd_g - rd_c)[rd_m].abs().max())
    pad_ok = bool((lu_g[~lu_m] == MASK_PAD).all()
                  and (rd_g[~rd_m] == MASK_PAD).all())
    if not (pad_ok and all(e <= TOL_MODEL for e in errs.values())):
        raise AssertionError(f'MLP model card vs cpu: {errs}, '
                             f'pad_ok={pad_ok}')
    err, bound, _ = ppo_grads_card_vs_cpu(mlp_gpu, mlp_cpu, obs_mlp,
                                          traj.actions[1], traj.log_probs[1],
                                          dev)
    mlp_launches = dict(segment_ops.launches)
    if mlp_launches != {'segment_mean': 0, 'segment_mean_backward': 0}:
        raise AssertionError(f'the MLP encoder launched {mlp_launches}')
    phase('mlp_model_card_vs_cpu', t0, encoder='mlp', rows=B,
          graph=[spec_g.NE, spec_g.num_features], max_abs_err=errs,
          tolerance=TOL_MODEL, masked_equal_pad=pad_ok,
          grad_parameters=len(err), grad_max_abs_err=max(err.values()),
          grad_max_err_over_bound=max(err[k] / bound[k] for k in err),
          grad_tolerance=[TOL_GRAD_REL, TOL_GRAD_ABS],
          kernel_launches=mlp_launches)
    del mlp_gpu, mlp_cpu, traj, obs_mlp, init_gg

    # ---- 5. the slice: batched HLG rollout ------------------------------
    t0 = time.time()
    bench.run_rollout_bench(num_envs=B, num_steps=2, device=dev)  # warm-up
    layers = model_cpu.num_gcn_layers
    segment_ops.reset_launches()
    stats = bench.run_rollout_bench(num_envs=B, num_steps=ROLLOUT_STEPS,
                                    device=dev)
    launches = dict(segment_ops.launches)
    expect = {'segment_mean': ROLLOUT_STEPS * layers,
              'segment_mean_backward': 0}
    if launches != expect:
        raise AssertionError(f'kernel launches {launches} != {expect}')
    if stats['episodes'] < 1:
        raise AssertionError('no episode completed in the rollout')
    if not np.isfinite(stats['mean_episode_reward']):
        raise AssertionError('non-finite rewards in the rollout')
    if not stats['overflow_gate_1pct_pass']:
        raise AssertionError(f'capacity gate: {stats}')
    phase('rollout', t0, kernel_launches=launches, **stats)

    # ---- 6. port GPU vs port CPU lockstep -------------------------------
    t0 = time.time()
    n_env, n_steps = 4, 10
    arng = np.random.default_rng(7)
    s_cpu = broadcast_state(init_cpu, n_env)
    agree = lockstep(spec, s_cpu, s_cpu.map(lambda x: x.to(dev)), n_steps,
                     lambda o: np.array(
                         [[int(arng.choice(np.nonzero(lu)[0]))
                           if lu.any() else 0, 0] for lu in o[6].numpy()],
                         dtype=np.int32))[0]
    phase('lockstep_gpu_vs_cpu', t0, envs=n_env, steps=n_steps,
          agreeing_steps=agree)

    # ---- 7. the training slice: one PPO train_iteration, then eval ------
    t0 = time.time()
    with tempfile.TemporaryDirectory() as run_dir:
        trainer = bench.make_trainer(TRAIN_ENVS, TRAIN_LEN, dev, seed=0,
                                     eval_envs=EVAL_ENVS, root_dir=run_dir)
        before = {k: p.detach().clone()
                  for k, p in trainer.model.named_parameters()}
        train = bench.measure_train_iteration(trainer)  # resets the counts
        train_launches = train['kernel_launches']
        mb_layers = train['update_minibatch_steps'] * layers
        expect = {'segment_mean': TRAIN_LEN * layers + mb_layers,
                  'segment_mean_backward': mb_layers}
        if train_launches != expect:
            raise AssertionError(f'train kernel launches {train_launches} '
                                 f'!= {expect}')
        if not all(np.isfinite(v) for v in train['losses'].values()):
            raise AssertionError(f'non-finite loss stats {train["losses"]}')
        # HLG plans land use only (skip_road): the road head's gradient is
        # exactly zero and Adam leaves it as it was; everything else moves
        unchanged = sorted(k for k, p in trainer.model.named_parameters()
                           if torch.equal(p, before[k]))
        if any(not k.startswith('road_head.') for k in unchanged):
            raise AssertionError(f'parameters the update left as they were: '
                                 f'{unchanged}')
        if train['episodes'] < 1:
            raise AssertionError('no episode ended in the train rollout')
        if not train['overflow_gate_1pct_pass']:
            raise AssertionError(f'capacity gate: {train}')
        phase('train', t0, unchanged_parameters=unchanged, **train)

        t0 = time.time()
        segment_ops.reset_launches()
        eval_r, chans = trainer.eval_agent(0)
        eval_launches = dict(segment_ops.launches)
        expect = {'segment_mean': TRAIN_LEN * layers,
                  'segment_mean_backward': 0}
        if eval_launches != expect:
            raise AssertionError(f'eval kernel launches {eval_launches} != '
                                 f'{expect}')
        if not all(np.isfinite(v) for v in (eval_r, *chans.values())):
            raise AssertionError(f'non-finite eval {eval_r} {chans}')
        phase('eval', t0, eval_envs=EVAL_ENVS, steps=TRAIN_LEN,
              mean_successful_reward=eval_r, channels=chans,
              best_reward=trainer.best_reward, kernel_launches=eval_launches)

    # ---- 8. the road-network reward, card vs CPU ------------------------
    t0 = time.time()
    init_np = tstate.plan_state_to_numpy(init_g_cpu)
    # the named networks (serpentine corridor, diagonal roads, ...) and
    # seeded random ones, ROAD_BATCH in all
    named = list(road_fixtures.reward_states(init_np).values())
    rand = road_fixtures.random_road_states(init_np, seed=11,
                                            batch=ROAD_BATCH - len(named))
    road_cpu = tstate.plan_state_from_numpy(
        {k: np.concatenate([np.stack([x[k] for x in named]), rand[k]])
         for k in init_np}, 'cpu')
    road, _ = compare_road_reward(spec_g, road_cpu, dev,
                                  'named and random networks')
    phase('road_reward_card_vs_cpu', t0, **road)

    # ---- 9. the concept reward, card vs CPU -----------------------------
    t0 = time.time()
    concept = {}
    for name in ('hlg_concept', 'dhm_concept'):
        _, spec_x, init_x = bench.setup(name, {}, 'cpu')
        concept[name] = compare_concept_reward(spec_x, init_x, dev)
    phase('concept_reward_card_vs_cpu', t0, batch=CONCEPT_BATCH, **concept)

    # ---- 10. the grid road stage, GPU vs CPU lockstep -------------------
    t0 = time.time()
    road_steps = road_lockstep(spec_g, init_np, dev)
    phase('road_lockstep_gpu_vs_cpu', t0, envs=ROAD_LOCKSTEP_ENVS,
          **road_steps)

    # ---- 11. the grid slice: one PPO train_iteration, land use + roads --
    t0 = time.time()
    with tempfile.TemporaryDirectory() as run_dir:
        trainer = bench.make_trainer(GRID_ENVS, GRID_LEN, dev, seed=0,
                                     root_dir=run_dir, name='grid')
        if (trainer.spec.num_features, trainer.spec.NE) != (2688, 3000):
            raise AssertionError('grid trainer graph is not (2688, 3000)')
        before = {k: p.detach().clone()
                  for k, p in trainer.model.named_parameters()}
        # keep the states and rewards of the episodes that end their road
        # stage without failure, as the collect's stage-reward pass leaves
        # them (the next step's auto-reset overwrites the states)
        terminal, road_rewards = [], []
        apply = rollout_mod.apply_stage_rewards

        def keep_terminal(spec_, states, reward, info):
            states, reward = apply(spec_, states, reward, info)
            fin = torch.nonzero(info['rd_done'] & ~info['failure'])[:, 0]
            road_rewards.append(reward[fin])
            if sum(len(r) for _, r in terminal) < ROAD_CPU_ENVS:
                terminal.append((states.map(lambda x: x[fin].clone()),
                                 reward[fin]))
            return states, reward
        rollout_mod.apply_stage_rewards = keep_terminal
        try:
            grid = bench.measure_train_iteration(trainer)  # resets counts
        finally:
            rollout_mod.apply_stage_rewards = apply
        grid_launches = grid['kernel_launches']
        mb_layers = grid['update_minibatch_steps'] * layers
        expect = {'segment_mean': GRID_LEN * layers + mb_layers,
                  'segment_mean_backward': mb_layers}
        if grid_launches != expect:
            raise AssertionError(f'grid train kernel launches '
                                 f'{grid_launches} != {expect}')
        if not all(np.isfinite(v) for v in grid['losses'].values()):
            raise AssertionError(f'non-finite loss stats {grid["losses"]}')
        unchanged = sorted(k for k, p in trainer.model.named_parameters()
                           if torch.equal(p, before[k]))
        if unchanged:
            raise AssertionError(f'parameters the grid update left as they '
                                 f'were: {unchanged}')
        final = torch.cat(road_rewards).cpu()
        if final.numel() < 1 or not bool(((final > 0) & (final <= 1)).all()):
            raise AssertionError(f'road rewards {final.tolist()}')
        if not grid['overflow_gate_1pct_pass']:
            raise AssertionError(f'capacity gate: {grid}')
        phase('grid_train', t0, unchanged_parameters=unchanged,
              road_successes=int(final.numel()),
              road_reward_range=[float(final.min()), float(final.max())],
              **grid)

    # the road reward on the collect's terminal states, card vs CPU, and
    # against the reward the collect gave them
    t0 = time.time()
    states = tstate.PlanState(*(
        torch.cat([getattr(x, n).cpu() for x, _ in terminal])[:ROAD_CPU_ENVS]
        for n in tstate.FIELD_NAMES))
    road_end, r_cpu = compare_road_reward(spec_g, states, dev,
                                          'grid collect terminal states')
    collect_r = torch.cat([r for _, r in terminal]).cpu()[:ROAD_CPU_ENVS]
    err = float((r_cpu - collect_r).abs().max())
    if not err <= TOL_ROAD:
        raise AssertionError(f'collect road reward vs cpu: {err}')
    phase('road_reward_card_vs_cpu', t0, collect_reward_max_abs_err=err,
          **road_end)

    # ---- 12. the grid's two-phase run_training -------------------------
    # the grid trainer's model and env batch go first, so that the peaks
    # below are the two-phase run's own
    del trainer
    t0 = time.time()
    held = torch.cuda.memory_allocated(dev)
    two = two_phase_grid(dev, layers)
    se = cfg_g.state_encoder_specs
    two_launches = {k: sum(c['launches'][k] for c in two['counted'])
                    for k in segment_ops.launches}
    gb = 1 / 2 ** 30
    phase('two_phase_grid', t0, seed=TWO_PHASE_SEED, envs=TWO_PHASE_ENVS,
          eval_envs=TWO_PHASE_EVAL_ENVS, rollout_len=TWO_PHASE_LEN,
          iterations_per_phase=1,
          widths={'gcn_node_dim': se['gcn_node_dim'], 'gcn_layers': layers,
                  'hidden': se['state_encoder_hidden_size']},
          phase1=two['phase1_spec'], stats=two['stats'],
          parts=two['counted'], kernel_launches=two_launches,
          warm_start_copied_total=list(two['warm_start']),
          frozen_boundaries=two['frozen_boundaries'],
          road_budget=two['total_road_steps'],
          road_mask_candidates=two['road_mask'],
          phase2_road_rewards=[float(two['road_rewards'].min()),
                               float(two['road_rewards'].max())],
          phase2_road_successes=int(two['road_rewards'].numel()),
          eval_rewards=[two['eval_1'][0], two['eval_2'][0]],
          unchanged_parameters=sorted(k for k, m in two['moved'].items()
                                      if not m),
          peak_gb={'held_before': held * gb,
                   'phase1': two['phase1_peak_bytes'] * gb,
                   'phase2': two['phase2_peak_bytes'] * gb},
          run_seconds=two['run_seconds'],
          resume_seconds=two['resume_seconds'], resume_same=True)

    # ---- 13. both kernels at the frozen plan's graph ------------------
    # timed here on a random graph unless kb.SHAPES lists the graph (then
    # phase 3 timed it), and checked on the frozen plan's own graph
    t0 = time.time()
    spec2 = two['spec2']
    p2 = ('grid_phase2', spec2.NE, spec2.num_features, se['gcn_node_dim'])
    listed = p2 in kb.SHAPES
    obs_p2 = make_batch_fns(spec2)[0](broadcast_state(two['init2'], 1))
    f2, b2, e_f, e_b = check_kernels(
        kb, segment_ops, dev,
        {'grid_phase2': ('grid_phase2_initial_observation', obs_p2)}, t0,
        shapes=[p2], random_graphs=not listed)
    fwd.update(f2)
    bwd.update(b2)
    fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    phase('phase2_graph_kernels', t0, shape=list(p2),
          in_kernel_bench_shapes=listed,
          backward_plan=segment_ops.backward_plan(p2[2], p2[3])._asdict())

    phase('total', t_start)
    shape = 'grid_trainer'
    kernels = [
        ('segment_mean',
         'urban_tpu/ops/pallas/segment_ops.py:61 (segment_mean_pallas) and '
         'urban_tpu/ops/pallas/segment_ops.py:130 '
         '(segment_mean_onehot_pallas)',
         launches['segment_mean'] + train_launches['segment_mean']
         + eval_launches['segment_mean'] + grid_launches['segment_mean']
         + two_launches['segment_mean'], fwd_err, fwd[shape]),
        ('segment_mean_backward',
         'none: no TPU counterpart (the Pallas segment-mean kernels of '
         'urban_tpu/ops/pallas/segment_ops.py have no gradient)',
         train_launches['segment_mean_backward']
         + grid_launches['segment_mean_backward']
         + two_launches['segment_mean_backward'], bwd_err, bwd[shape]),
    ]
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'urban_tpu_torch/csrc/{segment_ops.KERNELS[name][0]}',
        'replaces': replaces, 'launches': n, 'max_abs_err': err,
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': 'bytes', 'library_ms': t['library_ms'],
        'shape': shape}
        for name, replaces, n, err, t in kernels]}))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
