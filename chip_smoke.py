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
train_iteration with land use and roads (192 envs x 110 steps, 4 epochs of
minibatch 256), whose road head must learn. The MLP encoder (no message
passing, no kernel) runs on the card against the CPU, forward and one PPO
loss gradient. Then the grid's two-phase run_training (land use, the
freeze of the best greedy plan, roads) of one iteration a phase, its
resume from the phase-2 checkpoint, and both kernels at the frozen plan's
graph. Last, the reference API's host-env path: the port's `train` CLI on
the exact host environment (grid, two phases of one iteration, the policy
and the PPO update on the card), its `eval` CLI from the best checkpoint
on the card and on the CPU (the same greedy actions) and a baseline; both
kernels are also checked at the host observation's graph, at the
update's batch and at the policy step's batch of one. Then each kernel at
B = 0 (a data-parallel rank without rows: zeros, no launch); the HLG
trainer data parallel (run_training with 2 ranks sharing the card
through gloo) against one device: the same sampled actions, loss stats
and bitwise-equal ranks; the graft entry points (graft_entry) on the
card; and the GA path: the batched population fitness card vs CPU and
the train_ga CLI with its GeoJSON export. Then the fidelity tools: the
failure replay of the bench's rollout through the host oracle
(tools/replay_failures.py run_corpus on the card, one failure replayed
again with the env on the CPU), the host-oracle lockstep replay
(tools/divergence.py) with the env on the card against the CPU, and the
plan-scoring demo on the two-phase run's phase-2 best checkpoint and a
published plan. The launch counts show that each path went through its
kernels.
The tail, phases whose loops are host-bound while the card idles (the
road and concept reward checks, the GA phase, the failure replay and
both sides of the divergence replay), runs in child processes, each on
a core of its own, beside the graft entry points; the divergence
replay's CPU side starts after the HLG rollout.

    python3 chip_smoke.py --tail sequential|concurrent

builds the kernels and runs only that tail, in this process one phase
after another or in the child processes: what the children save.
One line per phase; the line before the last is one JSON object describing
each kernel, the last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA device or any check
fails. About 13-15 minutes on an H100, as fast as the host is.
"""
import argparse
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
# the HLG train_iteration's window, cut from 50 to 35 steps to pay for
# the host agent's phase: an HLG land-use episode takes ~29 steps, and at
# 25 every episode that ended was a failure (60 of 60 on the card), which
# weights every row zero and leaves the update nothing to learn
ROLLOUT_STEPS, TRAIN_ENVS, TRAIN_LEN, EVAL_ENVS = 30, 256, 35, 16
# the grid trainer's own batch (urban_tpu/cfg grid.yaml); its window cut
# from 120 to 110 steps to pay for the fidelity phases: a grid episode
# (land use, then roads) takes 96-111 steps, and most end within 110
GRID_ENVS, GRID_LEN = 192, 110
ROAD_BATCH, ROAD_CPU_ENVS, CONCEPT_BATCH, ROAD_LOCKSTEP_ENVS = 32, 32, 256, 8
# the grid's two-phase run: cfg.train() / cfg.finetune() halve the episode
# cap to 60 steps, which holds a land-use episode (about 48 steps) and a
# road one; the rollout is host-bound whatever the batch, so the envs are
# few, and one greedy eval env is enough (every greedy episode from the
# initial state is the same)
TWO_PHASE_SEED, TWO_PHASE_ENVS, TWO_PHASE_EVAL_ENVS, TWO_PHASE_LEN = 0, 8, 1, 60
# the host agent's train -> eval: the README's seed; the reference samples
# 500 episodes an iteration, cut to 8 (and to one iteration a phase)
HOST_SEED, HOST_EPISODES = 111, 8
TIE_GAP = 1e-5   # greedy card vs CPU: a top-2 logit gap this small may tie
# data parallelism on the one card: 2 ranks share it through gloo, each
# with 8 of the 16 envs (35 steps: HLG episodes end, as in `train`), 4
# epochs of 2 minibatches of 256 rows split between the ranks; the loss
# stats within the JAX dry run's gate of the one-device control
DP_RANKS, DP_ENVS, DP_LEN, DP_EVAL_ENVS, DP_GATE = 2, 16, 35, 2, 5e-2
DP_TIMEOUT = 900.0       # seconds, each spawned run
# the GA: GA_CMP_GENES greedy genes on HLG for 45 steps (as
# tests/test_ga_vmap.py), the card against the CPU within f32
# episode-reward rounding (4, not 8: the script passed 900 s with 8);
# then the train_ga CLI for one generation of GA_GENES, at the first of
# GA_SEEDS whose best gene's greedy host episode succeeds (a failed one
# has no plan)
GA_CMP_GENES, GA_GENES, GA_STEPS, TOL_GA = 4, 8, 45, 1e-5
GA_SEEDS = (0, 1, 2)
# the fidelity tools: two hlg seeds of the divergence sweep, card vs CPU
# (the CPU side in a child process from the start); the bench's failure
# replay at a quarter of its batch, a few failures and successes
DIVERGENCE_SEEDS = (100, 101)
REPLAY_ENVS, REPLAY_STEPS, REPLAY_FAILURES, REPLAY_SUCCESSES = 64, 30, 3, 2
REPLAY_BUDGET_S = 60.0


def phase(name, t0, **kv):
    print(json.dumps({'phase': name, 'seconds': round(time.time() - t0, 3),
                      **kv}), flush=True)


def check_kernels(kb, segment_ops, dev, real_obs, t0, shapes=None,
                  random_graphs=True):
    """Phase 3: the forward and the backward kernel against their plain
    versions at every shape of `shapes` (kb.SHAPES), at each of its batches
    (kb.BATCHES, else kb.B), timed on random graphs (unless random_graphs
    is False), and on a scenario's real graph where real_obs has one for
    the shape. Returns the times by shape (by f'{shape}_B{B}' at a batch
    other than kb.B) and the largest errors; the inputs, some of them GB,
    are freed on return, before the paths whose memory is measured."""
    rng = np.random.default_rng(0)
    fwd, bwd, fwd_err, bwd_err = {}, {}, 0.0, 0.0
    for shape, e, n, d, B in ((*s, b) for s in shapes or kb.SHAPES
                              for b in kb.BATCHES.get(s[0], (kb.B,))):
        key = shape if B == kb.B else f'{shape}_B{B}'
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
                device_ms, traces = kb.device_trace(kernel,
                                                    kb.FORWARD_KERNEL)
                times = fwd[key] = {
                    'ms': kb.cuda_time_ms(kernel),
                    'device_ms': device_ms, 'device_traces': traces,
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
                device_ms, traces = kb.device_trace(kernel,
                                                    kb.BACKWARD_KERNEL)
                times = bwd[key] = {
                    'ms': kb.cuda_time_ms(kernel),
                    'device_ms': device_ms, 'device_traces': traces,
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


def road_checks(dev):
    """Phases 8 and 10, [name, seconds, record] each: the road-network
    reward card vs CPU on the named networks (serpentine corridor,
    diagonal roads, ...) and seeded random ones, ROAD_BATCH in all; the
    grid road stage's lockstep, card vs CPU."""
    from urban_tpu_torch import bench
    from urban_tpu_torch.torchenv import road_fixtures
    from urban_tpu_torch.torchenv import state as tstate
    out = []
    t0 = time.time()
    _, spec_g, init_g = bench.setup('grid', {}, 'cpu')
    init_np = tstate.plan_state_to_numpy(init_g)
    named = list(road_fixtures.reward_states(init_np).values())
    rand = road_fixtures.random_road_states(init_np, seed=11,
                                            batch=ROAD_BATCH - len(named))
    road_cpu = tstate.plan_state_from_numpy(
        {k: np.concatenate([np.stack([x[k] for x in named]), rand[k]])
         for k in init_np}, 'cpu')
    road, _ = compare_road_reward(spec_g, road_cpu, dev,
                                  'named and random networks')
    out.append(['road_reward_card_vs_cpu', time.time() - t0, road])
    t0 = time.time()
    steps = road_lockstep(spec_g, init_np, dev)
    out.append(['road_lockstep_gpu_vs_cpu', time.time() - t0,
                dict(envs=ROAD_LOCKSTEP_ENVS, **steps)])
    return out


def concept_checks(dev):
    """Phase 9, [[name, seconds, record]]: the concept reward card vs CPU
    (hlg_concept, dhm_concept)."""
    from urban_tpu_torch import bench
    t0 = time.time()
    concept = {}
    for name in ('hlg_concept', 'dhm_concept'):
        _, spec_x, init_x = bench.setup(name, {}, 'cpu')
        concept[name] = compare_concept_reward(spec_x, init_x, dev)
    return [['concept_reward_card_vs_cpu', time.time() - t0,
             dict(batch=CONCEPT_BATCH, **concept)]]


def replay_phase(dev):
    """replay_failures_hlg at the SGNN's depth, for a child process."""
    from urban_tpu_torch.bench import load_config
    from urban_tpu_torch.ops import segment_ops
    layers = load_config('hlg').state_encoder_specs['num_gcn_layers']
    return replay_failures_hlg(dev, layers, segment_ops)


def two_phase_grid(dev, layers, keep_dir):
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
    the same parameters. The phase-2 best checkpoint is copied into
    keep_dir (for demo_score_plan). Returns the phase's record."""
    import shutil
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
        best_checkpoint = shutil.copy(
            os.path.join(trainer.cfg.model_dir, 'best.pt'),
            os.path.join(keep_dir, 'phase2_best.pt'))
        best_reward = trainer.best_reward
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
               road_rewards=road, moved=moved,
               best_checkpoint=best_checkpoint, best_reward=best_reward)
    return rec


def host_obs_tensors():
    """The grid host environment's initial observation (CityEnv at
    grid.yaml's caps: 3000 edge and 1000 node slots, the padded edges at
    the sentinel node 999, masked) as the policy's tensors on the CPU."""
    from urban_tpu_torch.agents.urban_agent import obs_to_torch
    from urban_tpu_torch.bench import load_config
    from urban_tpu_torch.host.envs.city import CityEnv
    from urban_tpu_torch.host.rl.memory import stack_obs
    return obs_to_torch(stack_obs([CityEnv(load_config('grid')).reset()]),
                        'cpu')


def same_greedy_actions(card, cpu, model_cpu):
    """Two greedy episodes' (observation, action) steps: the same actions,
    unless the CPU model's top-2 logit gap at the first differing step is
    under TIE_GAP (then the episodes part there, as in the CPU tests).
    Returns (steps compared, the gap at a tie or None)."""
    from urban_tpu_torch.agents.urban_agent import obs_to_torch
    for i, ((obs, a), (_, b)) in enumerate(zip(card, cpu)):
        if not np.array_equal(a, b):
            with torch.no_grad():
                lu, rd, stage, _ = model_cpu(obs_to_torch(obs, 'cpu'))
            logits = lu[0] if float(stage[0, 0]) > 0.5 else rd[0]
            top = torch.topk(logits, 2).values
            gap = float(top[0] - top[1])
            if not gap < TIE_GAP:
                raise AssertionError(f'greedy step {i}: card {a} cpu {b}, '
                                     f'top-2 gap {gap}')
            return i, gap
    if len(card) != len(cpu):
        raise AssertionError(f'greedy episodes of {len(card)} and '
                             f'{len(cpu)} steps')
    return len(card), None


def host_agent_grid(dev, layers):
    """The reference API's host-env PPO path on the card: the port's
    `train` CLI (grid, the README's seed, two phases of one iteration,
    HOST_EPISODES episodes an iteration, minibatch 256, 4 epochs), then its
    `eval` CLI from best.p on the card and on the CPU, and one baseline.
    Each sample, update and eval is counted on its own: `layers` forward
    launches a policy step, and for an update layers x (the frozen
    log-probs' chunks + minibatch steps) forward and layers x minibatch
    steps backward. In each phase every parameter moves but the other
    stage's head (phase 1 leaves the road head exactly as it was); phase
    2's road rewards lie in (0, 1]; the card's greedy episode is the
    CPU's. Returns the phase's record."""
    from urban_tpu_torch import eval as eval_cli
    from urban_tpu_torch import train as train_cli
    from urban_tpu_torch.agents import urban_agent as ua
    from urban_tpu_torch.host.rl.sampler import HostSampler
    from urban_tpu_torch.ops import segment_ops
    A = ua.UrbanPlanningAgent
    orig = {'select_fn': A._select_action_fn, 'update': A.update_params,
            'freeze': A.freeze_land_use, 'sample': HostSampler.sample,
            'eval': ua.eval_episode}
    pol = {'steps': 0, 'seconds': 0.0, 'trace': None}
    parts, rec = [], {'road_rewards': [], 'eval_rewards': {}}

    def select_fn(self):
        inner = orig['select_fn'](self)

        def select(obs, seed, mean_action):
            t = time.perf_counter()
            a = inner(obs, seed, mean_action)
            pol['seconds'] += time.perf_counter() - t
            pol['steps'] += 1
            if pol['trace'] is not None:
                pol['trace'].append((obs, np.asarray(a).reshape(2)))
            return a
        return select

    def phase_of(cfg):
        return 1 if cfg.skip_road else 2 if cfg.skip_land_use else 0

    def counted(part, fn, cfg_of):
        def wrapper(*a, **k):
            segment_ops.reset_launches()
            pol.update(steps=0, seconds=0.0)
            t = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts.append({'phase': phase_of(cfg_of(a)), 'part': part,
                          'seconds': time.time() - t,
                          'policy_steps': pol['steps'],
                          'policy_seconds': pol['seconds'],
                          'launches': dict(segment_ops.launches)})
            return out
        return wrapper

    def update(self, batch, iteration):
        before = {k: p.detach().clone()
                  for k, p in self.model.named_parameters()}
        orig['update'](self, batch, iteration)
        n = len(batch)
        mb = min(self.cfg.mini_batch_size, n)
        rec['param_names'] = [k for k, _ in self.model.named_parameters()]
        rec.setdefault('updates', []).append({
            'rows': n, 'chunks': -(-n // mb),
            'steps': self.cfg.num_optim_epoch * max(n // mb, 1),
            'unchanged': sorted(k for k, p in self.model.named_parameters()
                                if torch.equal(p, before[k]))})
        if phase_of(self.cfg) == 2:
            rec['road_rewards'].append(batch.rewards[batch.masks == 0])

    def evaluate(env, *a, **k):
        out = orig['eval'](env, *a, **k)
        rec['eval_rewards'][phase_of(env.cfg)] = out[0].avg_episode_reward
        return out

    def freeze(self):
        rec['phase1_peak_bytes'] = torch.cuda.max_memory_allocated(dev)
        rec['best_after_phase1'] = os.path.exists(
            os.path.join(self.cfg.model_dir, 'best.p'))
        orig['freeze'](self)
        torch.cuda.reset_peak_memory_stats(dev)

    def cli(module, *argv):
        return module.main(['--cfg', 'grid', '--global_seed', str(HOST_SEED),
                            '--root_dir', run_dir, *argv])

    with tempfile.TemporaryDirectory() as run_dir:
        A._select_action_fn = select_fn
        A.update_params = counted('update', update, lambda a: a[0].cfg)
        A.freeze_land_use = freeze
        HostSampler.sample = counted('sample', orig['sample'],
                                     lambda a: a[0].env.cfg)
        ua.eval_episode = counted('eval', evaluate, lambda a: a[0].cfg)
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.time()
            agent = cli(train_cli, '--max_num_iterations', '1',
                        '--num_episodes_per_iteration', str(HOST_EPISODES),
                        '--device', 'cuda')
            rec['train_seconds'] = time.time() - t
            rec['phase2_peak_bytes'] = torch.cuda.max_memory_allocated(dev)
            rec['best_final'] = os.path.exists(
                os.path.join(agent.cfg.model_dir, 'best.p'))
            rec['cfg'] = {'mini_batch_size': agent.cfg.mini_batch_size,
                          'num_optim_epoch': agent.cfg.num_optim_epoch,
                          'max_sequence_length':
                              agent.cfg.max_sequence_length,
                          'episodes_per_iteration':
                              agent.cfg.num_episodes_per_iteration}
            del agent
            traces = {}
            for where in ('cuda', 'cpu'):
                pol['trace'] = traces[where] = []
                t = time.time()
                ev, log = cli(eval_cli, '--iteration', 'best', '--device',
                              where)
                rec[f'eval_{where}'] = {'seconds': time.time() - t,
                                        'reward': log.avg_episode_reward,
                                        'steps': len(traces[where])}
            pol['trace'] = None
            rec['greedy_steps_compared'], rec['greedy_tie_gap'] = \
                same_greedy_actions(traces['cuda'], traces['cpu'], ev.model)
            del ev
            t = time.time()
            _, log = cli(eval_cli, '--agent', 'rule-centralized', '--device',
                         'cuda')
            rec['baseline'] = {'agent': 'rule-centralized',
                               'seconds': time.time() - t,
                               'reward': log.avg_episode_reward}
        finally:
            A._select_action_fn = orig['select_fn']
            A.update_params, A.freeze_land_use = orig['update'], orig['freeze']
            HostSampler.sample, ua.eval_episode = orig['sample'], orig['eval']

    # the eval CLI runs count as phase 0, in order: card, CPU, baseline
    got = [(p['phase'], p['part']) for p in parts]
    want = [(1, 'sample'), (1, 'update'), (1, 'eval'), (2, 'sample'),
            (2, 'update'), (2, 'eval'), (0, 'eval'), (0, 'eval'),
            (0, 'eval')]
    if got != want or not (rec['best_after_phase1'] and rec['best_final']):
        raise AssertionError(f'host agent parts {got}, best.p '
                             f'{rec["best_after_phase1"]} {rec["best_final"]}')
    updates = iter(rec['updates'])
    for p in parts:
        if p['part'] == 'update':
            u = p['update'] = next(updates)
            fwd, bwd = layers * (u['chunks'] + u['steps']), \
                layers * u['steps']
        elif p is parts[-2] or p is parts[-1]:   # the CPU, the baseline
            fwd = bwd = 0
        else:
            fwd, bwd = layers * p['policy_steps'], 0
        p['expected'] = {'segment_mean': fwd, 'segment_mean_backward': bwd}
        if p['launches'] != p['expected'] or p['policy_steps'] < 1 \
                and p['part'] != 'update':
            raise AssertionError(f'host agent launches {p}')
    # phase 1 (land use) leaves the road head as it was: its gradient is
    # zero and Adam starts from zero moments; phase 2 resumes best.p's
    # Adam moments, so the land-use head may still move by its momentum
    road_head = sorted(k for k in rec['param_names']
                       if k.startswith('road_head.'))
    u1, u2 = rec['updates']
    if u1['unchanged'] != road_head or not all(
            k.startswith('land_use_head.') for k in u2['unchanged']):
        raise AssertionError(f'unchanged parameters: phase 1 '
                             f'{u1["unchanged"]}, phase 2 {u2["unchanged"]}')
    road = np.concatenate(rec['road_rewards'])
    if road.size < 1 or not ((road > 0) & (road <= 1)).all() \
            or not 0 < rec['eval_rewards'][2] <= 1:
        raise AssertionError(f'phase-2 road rewards {road.tolist()}, eval '
                             f'{rec["eval_rewards"]}')
    if not all(np.isfinite(x['reward']) for x in (
            rec['eval_cuda'], rec['eval_cpu'], rec['baseline'])):
        raise AssertionError(f'non-finite eval rewards {rec}')
    rec.update(parts=parts, road_rewards=road)
    return rec


def empty_batch_kernels(segment_ops, dev, e, n, d):
    """One call of each kernel's wrapper at B = 0 on the card (a
    data-parallel rank without rows in a minibatch): zeros of the right
    shapes on the card, and no launch."""
    before = dict(segment_ops.launches)
    edges = torch.zeros((0, e, 2), dtype=torch.int32, device=dev)
    mask = torch.ones((0, e), dtype=torch.bool, device=dev)
    out, counts = segment_ops.segment_mean_counts(
        torch.zeros((0, e, d), device=dev), edges, mask, n)
    dh = segment_ops.segment_mean_backward(
        torch.zeros((0, n, d), device=dev), counts, edges, mask)
    torch.cuda.synchronize()
    shapes = [list(x.shape) for x in (out, counts, dh)]
    if shapes != [[0, n, d], [0, n], [0, e, d]] or any(
            x.device != dev for x in (out, counts, dh)) \
            or segment_ops.launches != before:
        raise AssertionError(f'B = 0: shapes {shapes}, launches '
                             f'{segment_ops.launches} (before {before})')
    return {'shapes': shapes, 'launches': 0}


def sampled_gaps(model, obs_seq, gen_state, B, dev):
    """Replays a collect of the trainer (its observations, the parameters
    and the generator state it started from): each step draws the explore
    draw, then each head's Gumbel noise, in the rollout's order. Returns
    (T, B) the gap between the top two perturbed logits of the head that
    chose each action (what a rounding difference would have to cross to
    change it) and the (T, B, 2) actions the replay takes."""
    from urban_tpu_torch.models.policy import gumbel_scores, uniform
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    gaps, picks = [], []
    with torch.no_grad():
        for t in range(obs_seq[0].shape[0]):
            uniform((B,), gen, dev)    # the explore draw (noise rate 1)
            lu, rd, stage, _ = model(tuple(o[t] for o in obs_seq))
            tops = [torch.topk(gumbel_scores(x, gen), 2, dim=-1)
                    for x in (lu, rd)]
            in_lu, in_rd = stage[:, 0] > 0.5, stage[:, 1] > 0.5
            gap = [x.values[:, 0] - x.values[:, 1] for x in tops]
            gaps.append(torch.where(in_lu, gap[0], torch.where(
                in_rd, gap[1], torch.inf)))
            picks.append(torch.stack([
                torch.where(in_lu, tops[0].indices[:, 0], 0),
                torch.where(in_rd, tops[1].indices[:, 0], 0)], dim=-1))
    return torch.stack(gaps).cpu().numpy(), \
        torch.stack(picks).cpu().numpy()


def dp_train_hlg(dev, layers):
    """run_training on HLG with DP_RANKS ranks sharing the card (spawned,
    gloo), then the same call on one device as the control, whose collect
    is kept for sampled_gaps. Every rank's parameters must be bitwise
    equal; each sampled action equal to the control's, or its env's first
    difference at a perturbed top-2 gap under TIE_GAP; the loss stats
    within DP_GATE of the control's; each rank's launches exact: collect
    and eval DP_LEN x layers forward, the update layers forward and
    backward for each minibatch step in which the rank held rows."""
    import copy
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl import trainer as trainer_mod
    from urban_tpu_torch.rl.ppo import STAT_KEYS
    T = trainer_mod.Trainer
    kept, orig_collect = {}, T.collect

    def collect(self):
        kept['generator'] = self.generator.get_state()
        kept['model'] = copy.deepcopy(self.model)
        traj = orig_collect(self)
        kept['obs'] = traj.obs
        return traj

    def run(root, n, device):
        return trainer_mod.run_training(
            Config('hlg', 0, root_dir=root), 1, DP_ENVS, num_devices=n,
            rollout_len=DP_LEN, eval_envs=DP_EVAL_ENVS, device=device,
            timeout=DP_TIMEOUT)

    with tempfile.TemporaryDirectory() as run_dir:
        t = time.time()
        ranks = run(os.path.join(run_dir, 'dp'), DP_RANKS, 'cuda')
        dp_seconds = time.time() - t
        T.collect = collect
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        try:
            one = run(os.path.join(run_dir, 'one'), 1, dev)
        finally:
            T.collect = orig_collect
        one_seconds = time.time() - t
        one_peak = torch.cuda.max_memory_allocated(dev)
    if [r['rank'] for r in ranks] != list(range(DP_RANKS)) or any(
            r['backend'] != 'gloo' or r['device'] != str(dev)
            for r in ranks):
        raise AssertionError('ranks ' + str([
            (r['rank'], r['backend'], r['device']) for r in ranks]))
    differ = sorted(k for r in ranks[1:] for k, v in r['params'].items()
                    if not torch.equal(v, ranks[0]['params'][k]))
    if differ:
        raise AssertionError(f'ranks\' parameters differ: {differ}')
    gaps, replayed = sampled_gaps(kept['model'], kept['obs'],
                                  kept['generator'], DP_ENVS, dev)
    control = one.last_actions
    dp_actions = np.concatenate([r['last_actions'] for r in ranks], axis=1)
    ties = {}
    for name, acts in (('replay', replayed), ('dp', dp_actions)):
        for b in range(DP_ENVS):
            bad = np.flatnonzero((acts[:, b] != control[:, b]).any(-1))
            if bad.size:
                ties.setdefault(name, []).append(
                    [b, int(bad[0]), float(gaps[bad[0], b])])
                if not gaps[bad[0], b] < TIE_GAP:
                    raise AssertionError(f'{name} env {b} step {bad[0]}: '
                                         f'{acts[bad[0], b]} vs control '
                                         f'{control[bad[0], b]}, gap '
                                         f'{gaps[bad[0], b]}')
    equal = int((dp_actions == control).all(-1).sum())
    (st_one,) = one.history
    rel = {k: abs(ranks[0]['history'][0].losses[k] - st_one.losses[k])
           / max(abs(st_one.losses[k]), 1e-9) for k in STAT_KEYS}
    if not max(rel.values()) < DP_GATE:
        raise AssertionError(f'dp loss stats vs control: {rel}')
    launches, per_rank = {}, []
    for r in [*ranks, None]:
        st = r['history'][0] if r else st_one
        steps = sum(1 for n in st.minibatch_rows if n)
        fwd = {'segment_mean': DP_LEN * layers, 'segment_mean_backward': 0}
        want = {'collect': fwd, 'eval': fwd,
                'update': {'segment_mean': steps * layers,
                           'segment_mean_backward': steps * layers}}
        if st.kernel_launches != want:
            raise AssertionError(f'rank {r and r["rank"]} launches '
                                 f'{st.kernel_launches} != {want}')
        for part in want.values():
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
        if r:
            per_rank.append({
                'rank': r['rank'], 'minibatch_rows': st.minibatch_rows,
                'launches': st.kernel_launches,
                'peak_gb': r['peak_bytes'] / 2 ** 30,
                't_sample_s': st.sample_time, 't_update_s': st.update_time,
                'episodes': st.episodes, 'failures': st.failures})
    rows = np.array([r['minibatch_rows'] for r in per_rank]).sum(0)
    if rows.tolist() != st_one.minibatch_rows:
        raise AssertionError(f'the ranks\' rows {rows.tolist()} are not the '
                             f'control\'s minibatches '
                             f'{st_one.minibatch_rows}')
    if not (st_one.episodes >= 1 and all(
            np.isfinite(v) for v in st_one.losses.values())):
        raise AssertionError(f'control iteration {st_one}')
    return {
        'ranks': per_rank, 'backend': ranks[0]['backend'],
        'ranks_per_device': ranks[0]['ranks_per_device'],
        'equal_actions': equal, 'actions': int(control.shape[0]
                                               * control.shape[1]),
        'first_differences_env_step_gap': ties,
        'min_perturbed_gap': float(gaps.min()),
        'loss_max_rel_diff': max(rel.values()), 'gate': DP_GATE,
        'losses': ranks[0]['history'][0].losses,
        'control_losses': st_one.losses,
        'params_max_abs_diff_vs_control': max(
            float((v.cpu() - ranks[0]['params'][k]).abs().max())
            for k, v in one.model.state_dict().items()),
        'episodes': [ranks[0]['history'][0].episodes, st_one.episodes],
        'eval_reward': [ranks[0]['history'][0].eval_reward,
                        st_one.eval_reward],
        'kernel_launches': launches,
        'control': {'t_sample_s': st_one.sample_time,
                    't_update_s': st_one.update_time,
                    'launches': st_one.kernel_launches,
                    'peak_gb': one_peak / 2 ** 30},
        'dp_seconds': dp_seconds, 'control_seconds': one_seconds}


def ga_fitness(dev):
    """The GA phase's first half: make_ga_population_fitness on HLG,
    GA_CMP_GENES greedy genes for GA_STEPS steps on the card and on the
    CPU, within TOL_GA. The GA runs no kernel."""
    from urban_tpu_torch import bench
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl.ga import make_ga_population_fitness
    _, spec, init = bench.setup('hlg', {}, 'cpu')
    genes = np.random.default_rng(0).uniform(-5, 5,
                                             size=(GA_CMP_GENES, 47))
    segment_ops.reset_launches()
    fit, secs = {}, {}
    for where in (dev, 'cpu'):
        t = time.time()
        fit[str(where)] = make_ga_population_fitness(
            spec, init, GA_STEPS, mean_action=True, seed=0,
            device=where)(genes)
        secs[str(where)] = time.time() - t
    card, cpu = fit[str(dev)], fit['cpu']
    err = float(np.abs(card - cpu).max())
    if not (err <= TOL_GA and (card > 0).any()):
        raise AssertionError(f'GA fitness card {card} cpu {cpu}')
    if any(segment_ops.launches.values()):
        raise AssertionError(f'the GA launched {segment_ops.launches}')
    return {'genes': GA_CMP_GENES, 'steps': GA_STEPS, 'fitness_card':
            card.tolist(), 'max_abs_err_vs_cpu': err, 'tolerance': TOL_GA,
            'fitness_seconds': secs}


def ga_train(dev):
    """The GA phase's second half: the train_ga CLI for one generation of
    GA_GENES with --tpu_env on the card, at the first of GA_SEEDS whose
    best gene's greedy host episode succeeds, its --export_geojson read
    back. No kernel."""
    from urban_tpu_torch import train_ga
    from urban_tpu_torch.host.io.geojson import load_geojson
    from urban_tpu_torch.ops import segment_ops
    segment_ops.reset_launches()
    attempts = []
    with tempfile.TemporaryDirectory() as run_dir:
        path = os.path.join(run_dir, 'plan.geojson')
        for seed in GA_SEEDS:
            t = time.time()
            agent, ga, plan = train_ga.main([
                '--cfg', 'hlg', '--global_seed', str(seed),
                '--num_generations', '1', '--sol_per_pop', str(GA_GENES),
                '--tpu_env', '--device', 'cuda', '--root_dir', run_dir,
                '--export_geojson', path])
            attempts.append({'seed': seed, 'seconds': time.time() - t,
                             'best_fitness': ga.best_solutions_fitness,
                             'greedy_plan': 'gdf' in plan})
            if 'gdf' in plan:
                break
        else:
            raise AssertionError(f'no greedy GA plan to export: {attempts}')
        table, want = load_geojson(path), plan['gdf']
        if not (len(table) == len(want) > 0
                and np.array_equal(table.ids, want.ids)
                and np.array_equal(table.types, want.types)):
            raise AssertionError('the exported GeoJSON plan reads back '
                                 'otherwise')
    if any(segment_ops.launches.values()):
        raise AssertionError(f'train_ga launched {segment_ops.launches}')
    return {'train_ga': attempts, 'exported_features': len(table),
            'kernel_launches': 0}


def divergence_side(dev):
    """One side of divergence_card_vs_cpu: tools/divergence.py's
    replay_episode on hlg at DIVERGENCE_SEEDS with the slot env on `dev`
    (no policy runs: no launch)."""
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.tools import divergence
    segment_ops.reset_launches()
    results, seconds = [], []
    for seed in DIVERGENCE_SEEDS:
        cfg = divergence.make_config('hlg')
        t = time.time()
        results.append(divergence.replay_episode(
            cfg, seed, max_steps=cfg.max_sequence_length + 20, device=dev))
        seconds.append(time.time() - t)
    return {'results': results, 'seconds': seconds,
            'launches': dict(segment_ops.launches)}


# the tail: phases whose times are not on record, each a host-bound loop
# that leaves the card idle most of the time (two processes sharing it
# each run as fast as one alone: PERF.md §6), so they run in child
# processes, each on a core of its own, beside the graft entry points:
# (phase function of this script, device)
TAIL = (('replay_phase', 'cuda'), ('road_checks', 'cuda'),
        ('concept_checks', 'cuda'), ('ga_fitness', 'cuda'),
        ('ga_train', 'cuda'), ('divergence_side', 'cuda'),
        ('divergence_side', 'cpu'))
# a TAIL phase in a child process; prints run_phase's result as its last
# line, one JSON object
PHASE_CHILD = r"""
import json, sys
import torch
import chip_smoke
from urban_tpu_torch import bench
torch.set_num_threads(chip_smoke.CHILD_THREADS)
bench.set_precision_flags()
print(json.dumps(chip_smoke.run_phase(*sys.argv[1:])))
"""
# intra-op threads of a child: seven of them share the host's cores with
# the graft entry points' ranks
CHILD_THREADS, CHILD_TIMEOUT = 2, 900.0


def run_phase(name, device):
    """A TAIL phase in this process: (its own seconds, its result)."""
    t = time.time()
    out = globals()[name](torch.device(device))
    return time.time() - t, out


def start_child(name, device):
    """A child process running the TAIL phase `name` on `device` from the
    checkout."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, '-c', PHASE_CHILD, name,
                             device], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def child_result(proc, what):
    """run_phase's result in a start_child child, once it has ended; its
    failure fails the phase."""
    out, err = proc.communicate(timeout=CHILD_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f'{what} failed: {err[-3000:]}')
    return json.loads(out.strip().splitlines()[-1])


def same_divergence_metrics(card, cpu):
    """The names of the keys where two replay_episode dicts differ: the
    slot env's reward (and the delta) beyond STATE_RTOL / STATE_ATOL,
    anything else (ints, bools, the host's reward) at all."""
    bad = sorted(set(card) ^ set(cpu))
    for k in set(card) & set(cpu):
        a, b = card[k], cpu[k]
        if k in ('reward_jax', 'reward_delta') and None not in (a, b):
            if not abs(a - b) <= STATE_ATOL + STATE_RTOL * abs(b):
                bad.append(k)
        elif a != b:
            bad.append(k)
    return bad


def divergence_card_vs_cpu(card_side, cpu_side):
    """tools/divergence.py's replay_episode with the slot env on the card
    against the same replay on the CPU for DIVERGENCE_SEEDS on hlg (each
    side divergence_side's result): equal dicts. The replay runs no
    policy: neither side may count a kernel launch."""
    got = {'cuda': card_side, 'cpu': cpu_side}
    card, cpu = card_side['results'], cpu_side['results']
    if len(card) != len(DIVERGENCE_SEEDS) or len(cpu) != len(card):
        raise AssertionError(f'{len(card)} card and {len(cpu)} CPU replays')
    for a, b in zip(card, cpu):
        bad = same_divergence_metrics(a, b)
        if bad or not a['completed_both']:
            raise AssertionError(f'seed {a["seed"]}: card {a} cpu {b}, '
                                 f'differ in {bad}')
    launches = card_side['launches']
    if any(launches.values()) or any(cpu_side['launches'].values()):
        raise AssertionError(f'the divergence replay launched {launches}')
    steps = sum(r['steps'] for r in card)
    return {'seeds': list(DIVERGENCE_SEEDS), 'card': card,
            'equal_to_cpu': True, 'tolerance': [STATE_RTOL, STATE_ATOL],
            'seed_seconds': {d: g['seconds'] for d, g in got.items()},
            'seconds_per_step': {d: sum(g['seconds']) / steps
                                 for d, g in got.items()},
            'kernel_launches': launches}


def replay_failures_hlg(dev, layers, segment_ops):
    """tools/replay_failures.py's run_corpus on the card at the bench caps
    (REPLAY_ENVS x REPLAY_STEPS, REPLAY_FAILURES failures and
    REPLAY_SUCCESSES successes within REPLAY_BUDGET_S host seconds): the
    corpus's rollout launches REPLAY_STEPS x layers forward segment means
    and the replay none; at least one failure and one success replayed;
    then the first replayed failure again with the env on the CPU, which
    must give the same outcome dict. Times each host (CityEnv.step) and
    card (env_step, synchronized) step of the replay, and records beside
    the outcomes each replayed episode's slot actions and the failure
    bits of the slot env's first failing step (none for a success)."""
    from urban_tpu_torch import bench
    from urban_tpu_torch.host.envs.city import CityEnv
    from urban_tpu_torch.torchenv import step as ts
    from urban_tpu_torch.tools import divergence
    from urban_tpu_torch.tools import replay_failures as rf
    orig = {'collect': rf.collect_trajectories, 'replay': rf.replay_one,
            'host': CityEnv.step, 'port': ts.env_step}
    kept, spent, bits = {}, {'host': [], 'port': []}, []

    def collect(*a, **k):
        kept['arrays'] = orig['collect'](*a, **k)
        return kept['arrays']

    def replay(*a, **k):
        bits.append(None)
        return orig['replay'](*a, **k)

    def timed(name):
        def step(*a, **k):
            t = time.time()
            out = orig[name](*a, **k)
            if name == 'port':
                torch.cuda.synchronize()
                code = int(out[3]['failure_code'])
                if code and bits[-1] is None:
                    bits[-1] = [n for bit, n in ts.FAILURE_BIT_NAMES.items()
                                if code & bit]
            spent[name].append(time.time() - t)
            return out
        return step
    rf.collect_trajectories, rf.replay_one = collect, replay
    CityEnv.step, ts.env_step = timed('host'), timed('port')
    segment_ops.reset_launches()
    t = time.time()
    try:
        metrics, fail_out, succ_out = rf.run_corpus(
            'hlg', B=REPLAY_ENVS, T=REPLAY_STEPS, budget_s=REPLAY_BUDGET_S,
            max_failures=REPLAY_FAILURES, n_success=REPLAY_SUCCESSES,
            verbose=False, device=dev)
    finally:
        rf.collect_trajectories, rf.replay_one = orig['collect'], \
            orig['replay']
        CityEnv.step, ts.env_step = orig['host'], orig['port']
    seconds = time.time() - t
    launches = dict(segment_ops.launches)
    expect = {'segment_mean': REPLAY_STEPS * layers,
              'segment_mean_backward': 0}
    if launches != expect:
        raise AssertionError(f'replay launches {launches} != {expect}')
    if not (fail_out and succ_out):
        raise AssertionError(f'replayed {len(fail_out)} failures and '
                             f'{len(succ_out)} successes: {metrics}')
    acts = kept['arrays'][0]
    replayed = fail_out + succ_out
    episodes = [{'env': r['env'], 't0': r['t0'], 't': r['t'],
                 'slot_actions': acts[r['t0']:r['t'] + 1, r['env']].tolist(),
                 'slot_failure_bits': b} for r, b in zip(replayed, bits)]
    ref = dict(fail_out[0])
    b, t_end, t0 = ref.pop('env'), ref.pop('t'), ref.pop('t0')
    _, spec, init = bench.setup('hlg', device='cpu')
    t = time.time()
    again = rf.replay_one(divergence.make_config('hlg'), spec, init,
                          acts[t0:t_end + 1, b], fail_step=t_end - t0,
                          device='cpu')
    cpu_seconds = time.time() - t
    if again != ref:
        raise AssertionError(f'failure replay card {ref} cpu {again}')
    return {'envs': REPLAY_ENVS, 'steps': REPLAY_STEPS,
            'budget_s': REPLAY_BUDGET_S, 'metrics': metrics,
            'failure_outcomes': fail_out, 'success_outcomes': succ_out,
            'replayed_episodes': episodes,
            'cpu_replay_same': True, 'cpu_replay_seconds': cpu_seconds,
            'cpu_replay_steps': int(t_end - t0 + 1),
            'replayed_steps': sum(r['steps'] for r in replayed),
            'seconds_per_step': {k: sum(v) / max(len(v), 1)
                                 for k, v in spent.items()},
            'steps_timed': {k: len(v) for k, v in spent.items()},
            'run_corpus_seconds': seconds, 'kernel_launches': launches}


def demo_score_plan(checkpoint, trainer_best_reward):
    """The demo (urban_tpu_torch.demo) on the grid two-phase run's phase-2
    best checkpoint and on the published grid plan: non-empty tables,
    finite rewards. The host score of the checkpoint's plan is printed
    beside the trainer's batched-env eval reward (a fidelity figure, not
    a gate)."""
    from urban_tpu_torch import demo
    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    for name, path in (('phase2_best_checkpoint', checkpoint),
                       ('grid_rl_tpu_geojson', os.path.join(
                           root, 'results', 'grid_rl_tpu.geojson'))):
        t = time.time()
        table = demo.load_plan_table(path)
        reward, info = demo.score_plan('grid', table, verbose=False)
        if not (len(table) > 0 and np.isfinite(reward)):
            raise AssertionError(f'demo on {name}: {len(table)} features, '
                                 f'reward {reward}')
        out[name] = {'features': len(table), 'host_reward': reward,
                     'channels': {k: v for k, v in info.items()
                                  if not isinstance(v, dict)},
                     'seconds': time.time() - t}
    out['phase2_best_checkpoint']['trainer_eval_reward'] = \
        trainer_best_reward
    return out


def tail(dev, children, concurrent=True):
    """The graft entry points (phase 17) and the TAIL phases (8-10, the
    GA, the failure replay, the divergence replay card vs CPU): with
    `concurrent`, each TAIL phase in a child process (those not yet in
    `children` started here) beside the graft entry points, else each in
    this process, one after another. Prints each phase with its own
    seconds, then the tail's wall seconds; returns the failure replay's
    record."""
    from urban_tpu_torch import graft_entry
    t_tail = time.time()
    if concurrent:
        for name, device in TAIL:
            if f'{name}:{device}' not in children:
                children[f'{name}:{device}'] = start_child(name, device)

    # ---- 17. the graft entry points -------------------------------------
    t0 = time.time()
    fn, args = graft_entry.entry('cuda')
    reward, done, value = fn(*args)
    torch.cuda.synchronize()
    shapes = [list(x.shape) for x in (reward, done, value)]
    if shapes != [[8], [8], [8, 1]] or not bool(
            torch.isfinite(reward).all() and torch.isfinite(value).all()):
        raise AssertionError(f'entry step {shapes}')
    dry = graft_entry.dryrun_multichip(DP_RANKS, 'cuda', timeout=DP_TIMEOUT)
    phase('graft_dryrun', t0, entry_shapes=shapes, ranks=DP_RANKS, **dry)

    # ---- 18. the TAIL phases, each with its own seconds ------------------
    got = {f'{name}:{device}': (
        child_result(children[f'{name}:{device}'], f'{name} on {device}')
        if concurrent else run_phase(name, device)) for name, device in TAIL}
    for key in ('road_checks:cuda', 'concept_checks:cuda'):
        for ph, secs, rec in got[key][1]:
            phase(ph, time.time() - secs, **rec)
    secs, replay = got['replay_phase:cuda']
    phase('replay_failures_hlg', time.time() - secs, **replay)
    (s_fit, fit), (s_train, train) = got['ga_fitness:cuda'], \
        got['ga_train:cuda']
    phase('ga_population_hlg', time.time() - s_fit - s_train, **fit, **train,
          parts_seconds={'fitness': s_fit, 'train_ga': s_train})
    (s_card, card), (s_cpu, cpu) = got['divergence_side:cuda'], \
        got['divergence_side:cpu']
    phase('divergence_card_vs_cpu', time.time() - s_card - s_cpu,
          **divergence_card_vs_cpu(card, cpu),
          sides_seconds={'cuda': s_card, 'cpu': s_cpu})
    phase('tail', t_tail, concurrent=concurrent,
          phase_seconds={key: got[key][0] for key in got})
    return replay


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tail', choices=('sequential', 'concurrent'),
                    help='build the kernels and run only the tail (the '
                    'graft entry points and the TAIL phases), one way or '
                    'the other: what the child processes save')
    args = ap.parse_args(argv)
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port has no CPU '
                         'fallback for this check')
    children = {}
    with tempfile.TemporaryDirectory() as keep_dir:
        try:
            if args.tail:
                from urban_tpu_torch import bench
                from urban_tpu_torch.ops import segment_ops
                bench.set_precision_flags()
                segment_ops.build_libraries()
                tail(torch.device('cuda', 0), children,
                     concurrent=args.tail == 'concurrent')
            else:
                smoke(t_start, children, keep_dir)
        finally:
            for proc in children.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def smoke(t_start, children, keep_dir):
    """Every phase, in order (the module docstring). children collects
    the child processes of the TAIL phases (the CPU side of the
    divergence replay starts after the HLG rollout, the others at the
    tail), keep_dir a directory that outlives the phases."""
    from urban_tpu_torch import bench
    from urban_tpu_torch import kernel_bench as kb
    from urban_tpu_torch.models.policy import MASK_PAD
    from urban_tpu_torch.ops import segment_ops
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
            spec_c)[0](broadcast_state(init_c, 1))),
        'host_obs': ('grid_host_env_initial_observation',
                     host_obs_tensors())}
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
    # the divergence replay's CPU side (one core, no card) from here on,
    # after the rollout whose env steps/s is the host's yardstick
    children['divergence_side:cpu'] = start_child('divergence_side', 'cpu')

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

    # ---- 8-10: the road and concept rewards card vs CPU and the grid
    # road stage's lockstep run in the tail (TAIL, phases 17-19)

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
    two = two_phase_grid(dev, layers, keep_dir)
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

    # ---- 13b. the demo on the phase-2 best plan and a published plan ----
    t0 = time.time()
    phase('demo_score_plan', t0, **demo_score_plan(two['best_checkpoint'],
                                                   two['best_reward']))

    # ---- 14. the host agent: train (two phases) -> eval -----------------
    t0 = time.time()
    host = host_agent_grid(dev, layers)
    host_launches = {k: sum(p['launches'][k] for p in host['parts'])
                     for k in segment_ops.launches}
    steps = {ph: sum(p['policy_steps'] for p in host['parts']
                     if p['phase'] == ph and p['part'] == 'sample')
             for ph in (1, 2)}
    host_s = {ph: sum(p['seconds'] - p['policy_seconds']
                      for p in host['parts']
                      if p['phase'] == ph and p['part'] == 'sample')
              for ph in (1, 2)}
    policy_s = {ph: sum(p['policy_seconds'] for p in host['parts']
                        if p['phase'] == ph and p['part'] == 'sample')
                for ph in (1, 2)}
    phase('host_agent_grid', t0, seed=HOST_SEED,
          episodes_per_iteration=HOST_EPISODES, iterations_per_phase=1,
          cfg=host['cfg'], parts=host['parts'],
          kernel_launches=host_launches,
          host_s_per_step={ph: host_s[ph] / steps[ph] for ph in steps},
          policy_s_per_step={ph: policy_s[ph] / steps[ph] for ph in steps},
          phase2_road_rewards=[float(host['road_rewards'].min()),
                               float(host['road_rewards'].max())],
          phase2_road_episodes=int(host['road_rewards'].size),
          eval_rewards=host['eval_rewards'], eval_cuda=host['eval_cuda'],
          eval_cpu=host['eval_cpu'], baseline=host['baseline'],
          greedy_steps_compared=host['greedy_steps_compared'],
          greedy_tie_gap=host['greedy_tie_gap'],
          peak_gb={'phase1': host['phase1_peak_bytes'] * gb,
                   'phase2': host['phase2_peak_bytes'] * gb},
          train_seconds=host['train_seconds'])

    # ---- 15. each kernel at B = 0 -----------------------------------------
    t0 = time.time()
    phase('empty_batch_kernels', t0, **empty_batch_kernels(
        segment_ops, dev, E_T, N_T, cfg_t.state_encoder_specs['gcn_node_dim']))

    # ---- 16. data parallelism: 2 ranks on the card vs one device ---------
    t0 = time.time()
    dp = dp_train_hlg(dev, layers)
    phase('dp_train_hlg', t0, envs=DP_ENVS, rollout_len=DP_LEN,
          eval_envs=DP_EVAL_ENVS, **dp)

    # both kernels at a rank's share of the update's minibatch (B 128 of
    # 256 at the HLG trainer's graph): timed on a random graph, checked on
    # the HLG trainer's initial observation
    t0 = time.time()
    f_dp, b_dp, e_f, e_b = check_kernels(
        kb, segment_ops, dev,
        {'dp_rank_update': ('hlg_initial_observation', obs_t)}, t0,
        shapes=[kb.DP_RANK_UPDATE])
    fwd.update(f_dp)
    bwd.update(b_dp)
    fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    phase('dp_rank_kernels', t0, shape=list(kb.DP_RANK_UPDATE),
          batch=kb.BATCHES['dp_rank_update'][0])

    # ---- 17-19: the graft entry points and the TAIL phases -------------
    replay = tail(dev, children)

    phase('total', t_start, hlg_rollout_env_steps_per_sec=stats[
        'env_steps_per_sec'])
    shape = 'grid_trainer'
    kernels = [
        ('segment_mean',
         'urban_tpu/ops/pallas/segment_ops.py:61 (segment_mean_pallas) and '
         'urban_tpu/ops/pallas/segment_ops.py:130 '
         '(segment_mean_onehot_pallas)',
         launches['segment_mean'] + train_launches['segment_mean']
         + eval_launches['segment_mean'] + grid_launches['segment_mean']
         + two_launches['segment_mean'] + host_launches['segment_mean']
         + dp['kernel_launches']['segment_mean']
         + replay['kernel_launches']['segment_mean'], fwd_err, fwd[shape]),
        ('segment_mean_backward',
         'none: no TPU counterpart (the Pallas segment-mean kernels of '
         'urban_tpu/ops/pallas/segment_ops.py have no gradient)',
         train_launches['segment_mean_backward']
         + grid_launches['segment_mean_backward']
         + two_launches['segment_mean_backward']
         + host_launches['segment_mean_backward']
         + dp['kernel_launches']['segment_mean_backward'], bwd_err,
         bwd[shape]),
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
