"""Smoke run of the PyTorch/CUDA port (urban_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the two CUDA kernels from the sources in the checkout (one nvcc per
source, all at once), prints the card's SM count and shared-memory limits
that the launch plans read (and whether the plans are the H100 SXM's),
and checks each kernel against its plain PyTorch version at
the shapes of the main paths: the forward segment mean, which every path
runs, and its backward, which the PPO update runs, each at the HLG
rollout's, the HLG trainer's, a large graph's, the grid trainer's, the
concept scenarios', the Huizhou trainer's and both two-phase graphs'
size, timed beside one
PyTorch library call and its memory bound
(urban_tpu_torch/kernel_bench.py). The backward must give the
plain version's bits, on the card and on the CPU. Then both kernels at
the range shapes (kernel_bench.RANGE_SHAPES: gcn_node_dim 24, 128 and 6 at
the HLG trainer's graph, HLG's nodes with 40,000 edge slots, a graph of
40,000 nodes and 100,000 edge slots at widths 16 and 24; the forward's
general plan and its runtime-width paths) with the same checks, the
general plan forced at the HLG and Huizhou trainer graphs, and the
runtime-width instantiation against the templated one, each with the
chosen plan's bits.
Runs the SGNN policy on the card against the same model on the CPU, and
one PPO loss backward on the card against the CPU. Drives the batched HLG
rollout (256 envs x 30 steps) through the captured CUDA graph of its step
(torchenv/program.py), as every rollout, collect and eval below runs;
then the same rollout stepped eagerly against the graph (the same
actions, counters, final states and generator state) and a profiler
trace of one replay, which must hold the forward kernel's launches; steps
GPU and CPU environments in lockstep, then runs one full HLG PPO
train_iteration (256 envs x 35 steps, 4 epochs of minibatch 256; its
collect also stepped eagerly first, which must take the same actions;
its update replays one captured CUDA graph of the minibatch step,
rl/update_program.py, with both kernels inside), then the same update
stepped eagerly on the same trajectory by a twin trainer from the same
seed (every parameter, Adam's state and every minibatch's stats equal;
a profiler trace of one replay must hold both kernels' launches) and a
16-env greedy evaluation. Then the road and
concept rewards on the card against the CPU, a road-stage lockstep of the
grid scenario on the card against the CPU, and one full grid PPO
train_iteration with land use and roads (192 envs x 110 steps, 4 epochs of
minibatch 256), whose road head must learn, its update held against a
twin trainer's eager update as the HLG one is. The MLP encoder (no message
passing, no kernel) runs on the card against the CPU, forward and one PPO
loss gradient, and the SGNN with bf16 encoder operands (the JAX encoder's
default numerics) card vs CPU on real HLG states. Then the grid's
two-phase run_training (land use, the
freeze of the best greedy plan, roads) of one iteration a phase, its
resume from the phase-2 checkpoint, and both kernels at the frozen plan's
graph. Last, the reference API's host-env path: the port's `train` CLI on
the exact host environment (grid, two phases of one iteration, the policy
and the PPO update on the card), its `eval` CLI from the best checkpoint
on the card and on the CPU (the same greedy actions) and a baseline, and
the policy step's captured graph against the eager step, bit for bit,
over the first POLICY_STEPS steps the train CLI took and, after other
parameters are loaded in place, again with the same graph; both
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
kernels; a replay adds the launches its capture made.
The tail, phases whose loops are host-bound while the card idles (the
road and concept reward checks, the GA phase, the failure replay, both
sides of the divergence replay, and two checks of the graphs against
eager steps: two HLG trainers from one seed, one eager, over two
iterations of collect, update and eval and a third collect, bit for bit;
the GA's population rollout through its captured step against eager;
the learning-parity recipe's trainer CLI at its full batch, 256 envs x
50 steps, for two iterations and a resumed third, with exact launches
every iteration, then the best plan's export, read back and host-scored;
the same recipe on Huizhou through tools/parity_run.py, 16 envs x 50
steps for one iteration, exact launches, then its export; the same
tool with --encoder mlp on HLG, 32 envs x 50 steps for one iteration,
no launch, then its export; the same tool on the planning-concept
scenario hlg_concept, 32 envs x 50 steps for one iteration, exact
launches, the concept reward timed, then its export with the plan's
concept term: the phase concept_train_export; the HLG trainer on the
card, stepping eagerly, against the same trainer on the CPU across two
iterations and a collect at 8 envs x 35 steps, from one initial draw on
one served noise, for the SGNN and the MLP, and the SGNN on hlg_concept
(started after the HLG rollout, as the divergence replay's CPU side is),
tools/card_lockstep.py: the phase trainer_card_vs_cpu, with each
parameter group's largest deviation an iteration and exact launches; the
same lockstep at gcn_node_dim 24 and 40,000 edge slots, the general plan
in its collect, update and eval, started after the range kernels: the
phase trainer_card_vs_cpu_wide; the two trainers graph against eager
at that config, bit for bit, started after the HLG rollout:
train_graph_vs_eager_wide; the same lockstep in grid's road phase, both
sides frozen on one plan with one warm start, 8 envs x 60 steps, started
after the HLG rollout and printed in trainer_card_vs_cpu; the same
lockstep on DHM (N = 1408 nodes, land use only), 8 envs x 35 steps,
started after the grid train iteration and printed there too; and grid's
two-phase recipe through tools/parity_run.py --separate_train, 16 envs x
60 steps, one iteration a phase, cut by its deadline at phase 2's first
iteration and resumed across the freeze, exact launches in each part of
each phase, then the export of phase 2's best plan with its host road
term beside the jit road reward: the phase two_phase_train_export),
runs in child processes, beside the graft entry points; the divergence
replay's CPU side starts after the HLG rollout.

    python3 chip_smoke.py --tail sequential|concurrent

builds the kernels and runs only that tail, in this process one phase
after another or in the child processes: what the children save.
One line per phase; the line before the last is one JSON object describing
each kernel, the last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA device or any check
fails. About 12 minutes on an H100, as fast as the host is.
"""
import argparse
import contextlib
import dataclasses
import io
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
# the two-phase recipe under the parity CLI, cut from 192 envs to TP_ENVS
# (the phase's 60-step window kept: 3 minibatches of 256 rows an epoch) and
# from 64 greedy eval envs to TP_EVAL_ENVS, one iteration a phase; the
# exported plan's host road term against the jit road reward of the same
# plan (JAX's record: equal to 4 decimals)
TP_ENVS, TP_EVAL_ENVS, TOL_EXPORT_ROAD = 16, 4, 1e-3
# the host agent's train -> eval: the README's seed; the reference samples
# 500 episodes an iteration, cut to 8 (and to one iteration a phase)
HOST_SEED, HOST_EPISODES = 111, 8
POLICY_STEPS = 600   # host policy steps replayed graphed and eagerly
POLICY_RELOAD_STEPS = 100   # again after new parameters are loaded
JAX_INIT = 'results/hlg_jax_init_seed111.npz'   # JAX's HLG initial draw
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
# graph vs eager across iterations: two HLG trainers from one seed, one
# stepping eagerly, TGE_ITERATIONS iterations of collect -> update ->
# eval and one more collect, TRAIN_LEN steps (episodes end: the update
# has rows to learn from); the batch cut to TGE_ENVS (4 minibatches of
# 256 rows an epoch), as an eager step takes ~0.45 s whatever the batch
TGE_ENVS, TGE_EVAL_ENVS, TGE_ITERATIONS = 32, 4, 2
# Huizhou under the parity recipe's CLI, cut from 192 envs to HZ_ENVS (the
# episode cap of 50 steps kept: 3 minibatches of 256 rows an epoch) and
# from 64 greedy eval envs to HZ_EVAL_ENVS, one iteration
HZ_ENVS, HZ_EVAL_ENVS = 16, 4
# the MLP ablation's path: the parity recipe's CLI with --encoder mlp on
# HLG, cut from 256 envs to MLP_ENVS (the 50-step window kept: 6
# minibatches of 256 rows an epoch) and from 64 greedy eval envs to
# MLP_EVAL_ENVS, one iteration
MLP_ENVS, MLP_EVAL_ENVS = 32, 4
# the planning-concept scenario hlg_concept under the parity recipe's CLI
# (its graph: 4000 edge slots, the forward's unstaged plan at B 256), cut
# from 256 envs to CONCEPT_ENVS (the 50-step window kept: 6 minibatches
# of 256 rows an epoch) and from 64 greedy eval envs to
# CONCEPT_EVAL_ENVS, one iteration
CONCEPT_ENVS, CONCEPT_EVAL_ENVS = 32, 4
# the trainer on the card against the same trainer on the CPU
# (tools/card_lockstep.py), each arm (the SGNN, the MLP) in a TAIL child
# whose CPU side runs in a spawned process meanwhile: LOCKSTEP_ENVS envs x
# TRAIN_LEN steps (280 rows: the update's minibatch of 256 takes the
# kernels' staged plan, the collect and the eval the split plan),
# LOCKSTEP_EVAL_ENVS greedy eval envs, LOCKSTEP_ITERATIONS iterations and
# a collect
LOCKSTEP_ENVS, LOCKSTEP_EVAL_ENVS, LOCKSTEP_ITERATIONS = 8, 2, 2
# the SGNN at a width and an edge count no shipped scenario has, which
# JAX's trainer takes as it takes any config: HLG's gcn_node_dim 16 -> 24
# (the kernels' runtime-width instantiations) and max_num_edges 3000 ->
# 40000 (keys past 16 bits: the forward's general plan in the collect at
# B 8, the update at B 256 and the eval at B 2; the backward's tile of 8)
WIDE_SPECS = {'gcn_node_dim': 24, 'max_num_edges': 40000}
# intra-op threads of the wide lockstep's CPU side, the longest child (on
# 2 threads its update of 256 rows of 40,000 edges took 652-837 s of
# CHILD_TIMEOUT's 900): done before the tail starts, it leaves the tail's
# children the host's cores
WIDE_REF_THREADS = 4


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
                names, per_call = kb.forward_kernels(
                    segment_ops.forward_plan(B, n, e, d))
                device_ms, traces = kb.device_trace(kernel, names,
                                                    per_call=per_call)
                times = fwd[key] = {
                    'ms': kb.cuda_time_ms(kernel),
                    'device_ms': device_ms, 'device_traces': traces,
                    'plain_ms': kb.cuda_time_ms(
                        lambda: segment_ops.segment_mean_counts_ref(
                            h, edges, mask, n)),
                    'library_ms': kb.cuda_time_ms(lib),
                    'bound_ms': kb.bound_ms(kb.forward_bytes(edges, mask, n,
                                                             d))}
            plan = segment_ops.forward_plan(B, n, e, d)
            phase('segment_mean_vs_plain', t0, shape=shape, graph=gname,
                  BEND=[B, e, n, d], plan=plan._asdict(),
                  resident_per_sm=None if plan.general else
                  segment_ops.load_library('segment_mean')
                  .segment_mean_resident(d, plan.threads, int(plan.staged),
                                         plan.shared_bytes),
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


def rollout_graph_vs_eager(bench, kb, segment_ops, dev, B, layers):
    """The bench's HLG rollout (B envs x ROLLOUT_STEPS from fresh envs,
    one seed) stepped eagerly, then through its captured graph: each step's
    actions, resets, dones and failures, the counters, the failure
    histogram, the final state, the generator's state after and the
    launch counts must be equal. Then one profiler trace of a single
    replay must hold exactly `layers` forward kernel events: the kernel
    runs inside the graph. Returns what it measured."""
    from urban_tpu_torch.torchenv.program import StepProgram
    from urban_tpu_torch.torchenv.rollout import broadcast_state, rollout_bench
    from urban_tpu_torch.torchenv.state import FIELD_NAMES
    cfg, spec, init = bench.setup('hlg', device=dev)
    model = bench.make_model(cfg, spec, seed=0, device=dev)
    start = broadcast_state(init.replace(done=torch.ones_like(init.done)), B)
    runs = {}
    for mode in ('eager', 'graph'):
        gen = torch.Generator(device=dev).manual_seed(1)
        record = []
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        program = StepProgram(spec, model, init, B, 'bench', gen,
                              eager=mode == 'eager')
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        segment_ops.reset_launches()
        out = rollout_bench(spec, model, init, start, gen, ROLLOUT_STEPS,
                            record=record, program=program)
        torch.cuda.synchronize(dev)
        runs[mode] = {'out': out, 'record': record, 'program': program,
                      'generator': gen.get_state(),
                      'launches': dict(segment_ops.launches),
                      'setup_seconds': t1 - t0,
                      'seconds': time.perf_counter() - t1}
    e, g = runs['eager'], runs['graph']

    def equal(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    checks = {
        'actions_resets_dones_failures': len(e['record']) == ROLLOUT_STEPS
        and all(equal(x, y) for x, y in zip(e['record'], g['record'])),
        'counters': equal(e['out'][1:4], g['out'][1:4]),
        'failure_histogram': torch.equal(e['out'][4], g['out'][4]),
        'final_state': equal([getattr(e['out'][0], n) for n in FIELD_NAMES],
                             [getattr(g['out'][0], n) for n in FIELD_NAMES]),
        'generator_state': torch.equal(e['generator'], g['generator']),
        'launches': e['launches'] == g['launches'] == {
            'segment_mean': ROLLOUT_STEPS * layers,
            'segment_mean_backward': 0}}
    if not all(checks.values()):
        raise AssertionError(f'graph vs eager: {checks}')
    program = g['program']
    trace = kb.one_trace(program.graph.replay, kb.FORWARD_KERNEL, reps=1)
    if trace['kernel_events'] != layers:
        raise AssertionError(f'a replay\'s trace holds {trace} forward '
                             f'kernel events, not {layers}')
    rates = {m: B * ROLLOUT_STEPS / r['seconds'] for m, r in runs.items()}
    return {'envs': B, 'steps': ROLLOUT_STEPS, 'checks': checks,
            'episodes': int(g['out'][1]), 'failures': int(g['out'][2]),
            'env_steps_per_sec': rates,
            'graph_speedup': rates['graph'] / rates['eager'],
            'seconds': {m: r['seconds'] for m, r in runs.items()},
            'program_setup_seconds': {m: r['setup_seconds']
                                      for m, r in runs.items()},
            'warmup_seconds': program.warmup_seconds,
            'capture_seconds': program.capture_seconds,
            'instantiate_seconds': program.instantiate_seconds,
            'graph_pool_bytes': program.pool_bytes,
            'replay_trace': trace}


@contextlib.contextmanager
def keeping_update(trainer, args, epochs):
    """Within the block, trainer.update keeps the trajectory and weights
    it takes in `args`, and every update epoch appends its minibatch
    stats to `epochs` (recording_epochs)."""
    update = trainer.update

    def keep(traj, iteration, weights=None):
        args[:] = [traj, weights]
        return update(traj, iteration, weights)
    trainer.update = keep
    try:
        with recording_epochs(epochs):
            yield
    finally:
        del trainer.update


@contextlib.contextmanager
def recording_epochs(into):
    """Within the block, every UpdateProgram.epoch appends its minibatch
    steps' stats, stacked (minibatches, len(STEP_KEYS)), to `into`."""
    from urban_tpu_torch.rl.update_program import UpdateProgram
    orig = UpdateProgram.epoch

    def epoch(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        into.append(torch.stack(self.minibatch_stats))
        return out
    UpdateProgram.epoch = epoch
    try:
        yield
    finally:
        UpdateProgram.epoch = orig


def adam_state(optimizer):
    """Every state tensor of the optimizer (exp_avg, exp_avg_sq, step of
    each parameter), in parameter order."""
    return [v for group in optimizer.param_groups for p in group['params']
            for _, v in sorted(optimizer.state[p].items())]


def update_graph_vs_eager(bench, kb, trainer, update_args, graph_epochs,
                          train, layers, run_dir, name, profile):
    """A train phase's update (4 epochs of minibatch 256 on the `name`
    trainer's iteration), which replayed the update program's captured
    graph, against the same update stepped eagerly on the same trajectory
    and weights by a twin trainer from the same seed (eager=True;
    capturable Adam both): every parameter, every Adam state tensor
    (exp_avg, exp_avg_sq, step), every minibatch's loss stats and
    gradient norm and the epoch's means must be equal, and a replay must
    count `layers` launches of each kernel. With `profile`, then one
    profiler trace of a single replay must hold exactly `layers` events
    of each kernel, and a trace of one more epoch through the graph and
    one eager gives the update's device-busy and idle share. Returns what
    it measured."""
    dev = trainer.device
    traj, weights = update_args
    T = trainer.rollout_len
    t = time.perf_counter()
    twin = bench.make_trainer(trainer.num_envs, T, dev, seed=0, eval_envs=1,
                              root_dir=run_dir, name=name, eager=True)
    twin_seconds = time.perf_counter() - t
    eager_epochs = []
    with recording_epochs(eager_epochs):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        stats = twin.update(traj, 0, weights=weights)
        torch.cuda.synchronize(dev)
        t_eager = time.perf_counter() - t
    mb = trainer.minibatch_size(T)
    program, eager_program = (x.update_program(mb) for x in (trainer, twin))
    params = list(zip(trainer.model.parameters(), twin.model.parameters()))
    adam = list(zip(adam_state(trainer.optimizer),
                    adam_state(twin.optimizer)))
    checks = {
        'graphed': program.graph is not None
        and eager_program.graph is None,
        'parameters': all(torch.equal(a, b) for a, b in params),
        'adam_state': len(adam) == 3 * len(params)
        and all(torch.equal(a, b) for a, b in adam),
        'minibatch_stats': len(graph_epochs) == len(eager_epochs) == 4
        and all(torch.equal(a, b) for a, b in zip(graph_epochs,
                                                  eager_epochs)),
        'epoch_means': train['losses'] == {k: float(v)
                                           for k, v in stats.items()},
        'replay_launches': program.launches == {
            'segment_mean': layers, 'segment_mean_backward': layers}}
    if not all(checks.values()):
        raise AssertionError(f'update graph vs eager: {checks}')
    steps = sum(len(e) for e in graph_epochs)
    out = {'cfg': name, 'envs': trainer.num_envs, 'steps': T,
           'minibatch_rows': mb, 'minibatch_steps': steps, 'checks': checks,
           't_update_s': {'graph': train['t_update_s'], 'eager': t_eager},
           'update_minibatch_steps_per_sec': {
               'graph': steps / train['t_update_s'],
               'eager': steps / t_eager},
           'update_program': bench.program_stats(program),
           'twin_trainer_seconds': twin_seconds}
    if not profile:
        return out
    # one replay is one more Adam step of the trainer, as is each step of
    # the profiled epochs below; the checks are done
    traces = {k: kb.one_trace(program.graph.replay, kernel, reps=1)
              for k, kernel in (('segment_mean', kb.FORWARD_KERNEL),
                                ('segment_mean_backward',
                                 kb.BACKWARD_KERNEL))}
    if any(x['kernel_events'] != layers for x in traces.values()):
        raise AssertionError(f'a replay\'s trace holds {traces}, not '
                             f'{layers} events of each kernel')
    rows = trainer.update_rows(traj, weights)
    epoch = trainer.epoch_minibatches(T, 1)[0]
    profiles = {}
    for mode, prog in (('graph', program), ('eager', eager_program)):
        prof = bench.device_profile(
            lambda prog=prog: prog.epoch(rows[:9], *rows[9:14], epoch,
                                         rows[14]), dev, len(epoch))
        profiles[mode] = dict(
            prof, device_busy_share=1.0 - prof['device_idle_share'])
    return dict(out, replay_traces=traces, epoch_profiles=profiles)


def train_graph_vs_eager(dev, encoder_specs=None):
    """Two HLG trainers from one seed (HLG's state_encoder_specs updated
    with `encoder_specs`), TGE_ENVS envs x TRAIN_LEN steps,
    one replaying its captured collect, update and eval programs (which
    share one graph pool; the collect graph reads the parameters that
    Adam updates in place between its replays), the other eager=True:
    TGE_ITERATIONS iterations of collect -> update -> eval, then one more
    collect. Every sampled action, parameter, Adam state tensor, loss
    stat and eval reward must be equal, bit for bit, and some rows must
    train; the launches of both trainers are counted. Runs in a TAIL
    child."""
    import gc
    from urban_tpu_torch import bench
    from urban_tpu_torch.ops import segment_ops
    segment_ops.reset_launches()
    runs = {}
    for mode in ('graph', 'eager'):
        with tempfile.TemporaryDirectory() as run_dir:
            tr = bench.make_trainer(TGE_ENVS, TRAIN_LEN, dev, seed=0,
                                    eval_envs=TGE_EVAL_ENVS,
                                    root_dir=run_dir, eager=mode == 'eager',
                                    encoder_specs=encoder_specs)
            t0 = time.time()
            its = []
            for it in range(TGE_ITERATIONS):
                st = tr.train_iteration(it)
                its.append({
                    'actions': tr.last_actions, 'losses': st.losses,
                    'eval_reward': st.eval_reward,
                    'best_reward': tr.best_reward,
                    'success_frac': st.success_frac,
                    'episodes': st.episodes,
                    't_sample_s': st.sample_time,
                    't_update_s': st.update_time,
                    'params': [p.detach().clone()
                               for p in tr.model.parameters()],
                    'adam': [t.clone() for t in adam_state(tr.optimizer)]})
            actions = tr.collect().actions.cpu().numpy()
            torch.cuda.synchronize(dev)
            runs[mode] = {
                'iterations': its, 'last_actions': actions,
                'seconds': time.time() - t0,
                'graphed': sorted({str(k[0]): v.graph is not None
                                   for k, v in tr.programs.items()}.items())}
            del tr   # its graphs and pool go before the next trainer's
            gc.collect()
            torch.cuda.empty_cache()
    launches = dict(segment_ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    g, e = runs['graph'], runs['eager']
    checks = {'graphed': g['graphed'] == [('collect', True), ('eval', True),
                                          ('update', True)]
              and not any(v for _, v in e['graphed'])}
    for i, (a, b) in enumerate(zip(g['iterations'], e['iterations'])):
        checks[f'iteration_{i}'] = {
            'actions': np.array_equal(a['actions'], b['actions']),
            'losses': a['losses'] == b['losses'],
            'eval_reward': a['eval_reward'] == b['eval_reward']
            and a['best_reward'] == b['best_reward'],
            'parameters': all(torch.equal(x, y) for x, y in zip(
                a['params'], b['params'])),
            'adam_state': all(torch.equal(x, y) for x, y in zip(
                a['adam'], b['adam']))}
    checks['last_collect_actions'] = np.array_equal(g['last_actions'],
                                                    e['last_actions'])
    trained = sum(it['success_frac'] for it in g['iterations'])
    ok = all(v if isinstance(v, bool) else all(v.values())
             for v in checks.values())
    if not (ok and trained > 0):
        raise AssertionError(f'train graph vs eager: {checks}, success '
                             f'fractions {trained}')
    return {'envs': TGE_ENVS, 'steps': TRAIN_LEN,
            'iterations': TGE_ITERATIONS, 'eval_envs': TGE_EVAL_ENVS,
            'encoder_specs': encoder_specs, 'checks': checks,
            'kernel_launches': launches, 'peak_allocated_gb': peak_gb,
            'per_iteration': [{k: it[k] for k in (
                'losses', 'eval_reward', 'success_frac', 'episodes')}
                for it in g['iterations']],
            'seconds': {m: r['seconds'] for m, r in runs.items()},
            't_sample_s': {m: [it['t_sample_s'] for it in r['iterations']]
                           for m, r in runs.items()},
            't_update_s': {m: [it['t_update_s'] for it in r['iterations']]
                           for m, r in runs.items()}}


def train_graph_vs_eager_wide(dev):
    """train_graph_vs_eager at WIDE_SPECS: the general plan and the
    runtime-width paths captured in the step and update graphs, bit for
    bit against eager steps; each trainer's launches exact (TRAIN_LEN x
    layers forward in each collect and eval, minibatch steps x layers of
    each kernel in each update). Runs in a TAIL child."""
    from urban_tpu_torch.host.utils.config import Config
    out = train_graph_vs_eager(dev, WIDE_SPECS)
    with tempfile.TemporaryDirectory() as root:
        cfg = Config('hlg', 0, root_dir=root)
    layers = cfg.state_encoder_specs['num_gcn_layers']
    mb = cfg.num_optim_epoch * max(
        TGE_ENVS * TRAIN_LEN // cfg.mini_batch_size, 1) * layers
    fwd = TRAIN_LEN * layers
    expect = {'segment_mean': 2 * (TGE_ITERATIONS * (2 * fwd + mb) + fwd),
              'segment_mean_backward': 2 * TGE_ITERATIONS * mb}
    if out['kernel_launches'] != expect:
        raise AssertionError(f'wide train graph vs eager launches '
                             f'{out["kernel_launches"]} != {expect}')
    return out


@contextlib.contextmanager
def entry_states(into):
    """Within the block, every Trainer.train_iteration appends to `into`,
    on entry, its iteration, the parameters and Adam's state (on the
    CPU)."""
    from urban_tpu_torch.rl.trainer import Trainer
    orig = Trainer.train_iteration

    def train_iteration(self, iteration, do_eval=True):
        into.append({
            'iteration': iteration,
            'params': {k: v.detach().cpu().clone()
                       for k, v in self.model.state_dict().items()},
            'adam': {i: {k: v.cpu().clone() for k, v in s.items()}
                     for i, s in self.optimizer.state_dict()[
                         'state'].items()}})
        return orig(self, iteration, do_eval)
    Trainer.train_iteration = train_iteration
    try:
        yield
    finally:
        Trainer.train_iteration = orig


@contextlib.contextmanager
def eval_returns(into):
    """Within the block, every Trainer.eval_agent appends to `into` what
    it returns: the mean greedy reward and the mean reward channels."""
    from urban_tpu_torch.rl.trainer import Trainer
    orig = Trainer.eval_agent

    def eval_agent(self, iteration):
        into.append(orig(self, iteration))
        return into[-1]
    Trainer.eval_agent = eval_agent
    try:
        yield
    finally:
        Trainer.eval_agent = orig


def train_resume_export_hlg(dev):
    """The learning-parity recipe's trainer CLI (rl.trainer.main with
    tools/parity_run.RECIPE: hlg, 256 envs x 50 steps, 4 epochs of
    minibatch 256, 64 greedy eval envs, seed 111, normalized advantages,
    tau 0.95) for 2 iterations, then resumed from its final.pt for a
    third. The resumed run must train iteration 2 alone, starting from the
    checkpoint's parameters and Adam state; every iteration must launch
    exactly rollout_len x layers forward kernels in collect and in eval
    and minibatch steps x layers of each kernel in the update. Then
    tools/export_best_plan on best.pt: the GeoJSON reads back with the
    filled plan's type counts and the host score is finite. Runs in a TAIL
    child."""
    from urban_tpu_torch.host import city_config
    from urban_tpu_torch.host.io.geojson import load_geojson
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl import trainer as trainer_mod
    from urban_tpu_torch.tools import export_best_plan, parity_run
    from urban_tpu_torch.torchenv.state import state_to_table
    out = {'recipe': parity_run.RECIPE, 'runs': []}
    with tempfile.TemporaryDirectory() as root:
        argv = parity_run.RECIPE + ['--root_dir', root, '--device', str(dev)]
        entries = []
        launches = dict.fromkeys(segment_ops.launches, 0)
        for run in (['--iterations', '2'], ['--iterations', '3', '--resume',
                                            os.path.join(root, 'hlg', '111',
                                                         'models',
                                                         'final.pt')]):
            resume = '--resume' in run
            ckpt = (trainer_mod.read_checkpoint(run[-1]) if resume else None)
            t0 = time.time()
            torch.cuda.reset_peak_memory_stats(dev)
            segment_ops.reset_launches()
            with entry_states(entries):
                tr = trainer_mod.main(argv + run)
            torch.cuda.synchronize(dev)
            counted = dict(segment_ops.launches)
            seconds = time.time() - t0
            layers = tr.cfg.state_encoder_specs['num_gcn_layers']
            its = []
            for h in tr.history:
                mb_layers = len(h.minibatch_rows) * layers
                expect = {
                    'collect': {'segment_mean': tr.rollout_len * layers,
                                'segment_mean_backward': 0},
                    'update': {'segment_mean': mb_layers,
                               'segment_mean_backward': mb_layers},
                    'eval': {'segment_mean': tr.rollout_len * layers,
                             'segment_mean_backward': 0}}
                if h.kernel_launches != expect:
                    raise AssertionError(f'iteration {h.iteration} launches '
                                         f'{h.kernel_launches} != {expect}')
                its.append({
                    'iteration': h.iteration, 't_sample_s': h.sample_time,
                    't_update_s': h.update_time, 't_eval_s': h.eval_time,
                    'steps_per_sec': h.steps_per_sec,
                    'episodes': h.episodes, 'failures': h.failures,
                    'mean_episode_reward': h.mean_episode_reward,
                    'eval_reward': h.eval_reward, 'losses': h.losses,
                    'kernel_launches': {k: sum(p[k] for p in
                                               h.kernel_launches.values())
                                        for k in counted}})
            if counted != {k: sum(i['kernel_launches'][k] for i in its)
                           for k in counted}:
                raise AssertionError(f'launches {counted} outside the '
                                     'iterations')
            for k in launches:
                launches[k] += counted[k]
            if resume:
                first = entries[-1]
                same_params = first['params'].keys() == ckpt['params'].keys() \
                    and all(torch.equal(v, ckpt['params'][k])
                            for k, v in first['params'].items())
                want = ckpt['opt_state']['state']
                same_adam = first['adam'].keys() == want.keys() and all(
                    s.keys() == want[i].keys() and all(
                        torch.equal(v, want[i][k].cpu())
                        for k, v in s.items())
                    for i, s in first['adam'].items())
                trained = [h.iteration for h in tr.history]
                if not (trained == [2] and first['iteration'] == 2
                        and same_params and same_adam):
                    raise AssertionError(
                        f'resume: iterations {trained}, entry '
                        f'{first["iteration"]}, parameters equal '
                        f'{same_params}, Adam equal {same_adam}')
            elif [h.iteration for h in tr.history] != [0, 1]:
                raise AssertionError('the first run did not train 0, 1')
            out['runs'].append({
                'argv': run, 'seconds': seconds, 'iterations': its,
                'kernel_launches': counted,
                'best_reward': tr.best_reward,
                'best_iteration': tr.best_iteration,
                'peak_allocated_gb': torch.cuda.max_memory_allocated(dev)
                / 2 ** 30})
            del tr
            torch.cuda.empty_cache()
        out['resume_same_parameters_and_adam'] = True
        out['kernel_launches'] = launches

        # the export of best.pt: the filled plan reads back, host-scored
        best = os.path.join(root, 'hlg', '111', 'models', 'best.pt')
        geojson = os.path.join(root, 'best.geojson')
        ckpt = trainer_mod.read_checkpoint(best)
        if ckpt['best_plan_state'] is None:
            raise AssertionError('no greedy eval succeeded: best.pt holds no '
                                 'plan')
        t0 = time.time()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = export_best_plan.main(['--cfg', 'hlg', '--ckpt', best,
                                        '--out', geojson])
        lines = printed.getvalue().splitlines()
        host = float(lines[1].split(': ')[1]) if rc == 0 else float('nan')
        table = state_to_table(ckpt['best_plan_state'])
        table.types[table.alive_mask_of(city_config.FEASIBLE)] = \
            city_config.GREEN_S
        back = load_geojson(geojson)

        def type_counts(t):
            kinds, n = np.unique(t.types[t.existence], return_counts=True)
            return dict(zip(kinds.tolist(), n.tolist()))
        counts, counts_back = type_counts(table), type_counts(back)
        if not (rc == 0 and counts == counts_back and np.isfinite(host)
                and city_config.FEASIBLE not in counts_back):
            raise AssertionError(f'export: rc {rc}, type counts {counts} / '
                                 f'{counts_back}, host {host}')
        out['export'] = {'seconds': time.time() - t0, 'rc': rc,
                         'printed': lines[0], 'host_reward': host,
                         'jit_best_reward': ckpt['best_reward'],
                         'best_iteration': ckpt['best_iteration'],
                         'type_counts': counts_back}
    return out


def unmoved_parameters(after, before):
    """The names of the parameters (name -> tensor) equal in `after` and
    `before`, checked to be the road head's alone: on a land-use-only
    scenario (skip_road) its gradient is exactly zero and Adam leaves it
    as it was; every other parameter must move."""
    unchanged = sorted(k for k, p in after.items()
                       if torch.equal(p.detach().cpu(), before[k].cpu()))
    if any(not k.startswith('road_head.') for k in unchanged):
        raise AssertionError(f'parameters the update left as they were: '
                             f'{unchanged}')
    return unchanged


def parity_train_export(dev, flags):
    """tools/parity_run.py's recipe, the flags `flags` after the tool's
    own, for one iteration on `dev`; then tools/export_best_plan on its
    best.pt: a finite host score, or the record says that no greedy eval
    succeeded. Returns the phase's record: what ran (the summary's
    `effective`), the iteration's times, episodes, failures, losses and
    eval with its reward channels, its launches in each part and those
    counted over the run, the parameters it left as they were
    (unmoved_parameters: the road head's alone may stay), the peak memory
    and the export."""
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl import trainer as trainer_mod
    from urban_tpu_torch.tools import export_best_plan, parity_run
    with tempfile.TemporaryDirectory() as root:
        entries, evals = [], []
        torch.cuda.reset_peak_memory_stats(dev)
        segment_ops.reset_launches()
        t0 = time.time()
        with entry_states(entries), eval_returns(evals):
            summary = parity_run.main([
                '--iterations', '1', '--root_dir', root,
                '--stats', os.path.join(root, 'stats.jsonl'), *flags,
                '--device', str(dev)])
        torch.cuda.synchronize(dev)
        counted = dict(segment_ops.launches)
        seconds = time.time() - t0
        cfg_id = summary['effective']['cfg']
        with open(os.path.join(root, 'stats.jsonl')) as f:
            (st,) = [json.loads(line) for line in f
                     if not line.startswith('{"summary"')]
        models = os.path.join(root, cfg_id, '111', 'models')
        final = trainer_mod.read_checkpoint(os.path.join(models,
                                                         'final.pt'))
        unchanged = unmoved_parameters(final['params'],
                                       entries[0]['params'])

        t1 = time.time()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = export_best_plan.main([
                '--cfg', cfg_id, '--ckpt', os.path.join(models, 'best.pt'),
                '--out', os.path.join(root, 'best.geojson')])
        lines = printed.getvalue().splitlines()
        if rc == 0:
            host = float(lines[1].split(': ')[1])
            if not np.isfinite(host):
                raise AssertionError(f'export: host score {host}')
            export = {'rc': rc, 'printed': lines[0], 'host_reward': host}
            if lines[-1].startswith('concept: '):
                export['concept'] = float(lines[-1].split(': ')[1])
        elif lines == ['checkpoint has no best_plan_state']:
            export = {'rc': rc, 'printed': 'no greedy eval succeeded: no '
                      'plan to export', 'host_reward': None}
        else:
            raise AssertionError(f'export: rc {rc}, {lines}')
        export.update(seconds=time.time() - t1,
                      jit_best_reward=summary['best_reward'],
                      best_iteration=summary['best_iteration'])
    return {'effective': summary['effective'], 'seconds': seconds,
            't_sample_s': st['sample_time'], 't_update_s': st['update_time'],
            't_eval_s': st['eval_time'], 'episodes': st['episodes'],
            'failures': st['failures'],
            'failure_causes': st['failure_causes'],
            'mean_episode_reward': st['mean_episode_reward'],
            'eval_reward': st['eval_reward'],
            'eval_channels': evals[-1][1], 'losses': st['losses'],
            'minibatch_steps': len(st['minibatch_rows']),
            'iteration_kernel_launches': st['kernel_launches'],
            'kernel_launches': counted, 'unchanged_parameters': unchanged,
            'peak_allocated_bytes': summary['peak_allocated_bytes'],
            'export': export}


def huizhou_train_export(dev):
    """The parity recipe's CLI (tools/parity_run.py) on Huizhou, the
    scenario of JAX's round-5 record: --cfg huizhou at HZ_ENVS envs x the
    50-step episode cap, 4 epochs of minibatch 256, HZ_EVAL_ENVS greedy
    eval envs, seed 111, one iteration. The summary must name what ran;
    the iteration must launch exactly rollout_len x layers forward kernels
    in collect and in eval and minibatch steps x layers of each kernel in
    the update; every parameter but the road head's must move. Then
    tools/export_best_plan on best.pt (parity_train_export). Runs in a
    TAIL child."""
    out = parity_train_export(dev, ['--cfg', 'huizhou', '--num_envs',
                                    str(HZ_ENVS), '--eval_envs',
                                    str(HZ_EVAL_ENVS)])
    eff = out['effective']
    if (eff['cfg'], eff['num_envs'], eff['eval_envs'], eff['seed'],
            eff['encoder']) != ('huizhou', HZ_ENVS, HZ_EVAL_ENVS, 111,
                                'sgnn'):
        raise AssertionError(f'the run was not the recipe: {eff}')
    check_iteration_launches(out)
    return out


def check_iteration_launches(out):
    """A one-iteration parity_train_export record of the SGNN must have
    launched exactly rollout_len x layers forward kernels in collect and
    in eval and minibatch steps x layers of each kernel in the update,
    and nothing else over the run."""
    from urban_tpu_torch.rl import trainer as trainer_mod
    eff, counted = out['effective'], out['kernel_launches']
    with tempfile.TemporaryDirectory() as root:
        cfg = trainer_mod.Config(eff['cfg'], 111, root_dir=root)
    layers = cfg.state_encoder_specs['num_gcn_layers']
    mb_layers = cfg.num_optim_epoch * (
        eff['num_envs'] * eff['rollout_len'] // cfg.mini_batch_size) * layers
    steps = eff['rollout_len'] * layers
    expect = {'collect': {'segment_mean': steps,
                          'segment_mean_backward': 0},
              'update': {'segment_mean': mb_layers,
                         'segment_mean_backward': mb_layers},
              'eval': {'segment_mean': steps,
                       'segment_mean_backward': 0}}
    total = {k: sum(p[k] for p in expect.values()) for k in counted}
    if out['iteration_kernel_launches'] != expect or counted != total:
        raise AssertionError(f'launches {out["iteration_kernel_launches"]}'
                             f' / {counted} != {expect}')


def concept_train_export(dev):
    """The path of the planning-concept scenario's long run: the parity
    recipe's CLI (tools/parity_run.py) with --cfg hlg_concept at
    CONCEPT_ENVS envs x the recipe's 50-step window, 4 epochs of minibatch
    256, CONCEPT_EVAL_ENVS greedy eval envs, seed 111, one iteration (the
    concept reward, timed by the tool, computed where an episode's land
    use ends), then tools/export_best_plan on best.pt, which prints the
    plan's concept term beside the host score (parity_train_export). The
    summary must name what ran; the launches must be exact
    (check_iteration_launches); every parameter but the road head's must
    move; an episode must end in the collect, with the concept reward
    computed; the losses must be finite. Runs in a TAIL child."""
    from urban_tpu_torch.tools import parity_run
    times = []
    timer_call = parity_run.ConceptTimer.__call__

    def kept(self, spec, state):
        out = timer_call(self, spec, state)
        times[:] = [dict(self.seconds), dict(self.calls)]
        return out
    parity_run.ConceptTimer.__call__ = kept
    try:
        out = parity_train_export(dev, [
            '--cfg', 'hlg_concept', '--num_envs', str(CONCEPT_ENVS),
            '--eval_envs', str(CONCEPT_EVAL_ENVS)])
    finally:
        parity_run.ConceptTimer.__call__ = timer_call
    eff = out['effective']
    if (eff['cfg'], eff['num_envs'], eff['rollout_len'], eff['eval_envs'],
            eff['seed'], eff['encoder'], eff['encoder_operands']) != (
            'hlg_concept', CONCEPT_ENVS, 50, CONCEPT_EVAL_ENVS, 111, 'sgnn',
            'f32'):
        raise AssertionError(f'the run was not the recipe: {eff}')
    check_iteration_launches(out)
    if out['episodes'] < 1 or not times or times[1]['collect'] < 1:
        raise AssertionError(f'no concept reward in the collect: '
                             f'{out["episodes"]} episodes, {times}')
    if not all(np.isfinite(v) for v in out['losses'].values()):
        raise AssertionError(f'non-finite losses {out["losses"]}')
    export = out['export']
    if export['host_reward'] is not None and not (
            0.0 <= export.get('concept', -1.0) <= 1.0):
        raise AssertionError(f'export: no concept term in {export}')
    out.update(concept_reward_s=times[0], concept_reward_calls=times[1])
    return out


def mlp_train_hlg(dev):
    """The path of the MLP ablation's long run: the parity recipe's CLI
    (tools/parity_run.py) with --encoder mlp on HLG, at MLP_ENVS envs x
    the recipe's 50-step window, 4 epochs of minibatch 256, MLP_EVAL_ENVS
    greedy eval envs, seed 111, one iteration, then tools/export_best_plan
    on best.pt (parity_train_export). The summary must name what ran;
    neither kernel may launch in any part of the iteration, every
    parameter but the road head's must move, the losses and the eval must
    be finite. Runs in a TAIL child."""
    out = parity_train_export(dev, ['--encoder', 'mlp', '--num_envs',
                                    str(MLP_ENVS), '--eval_envs',
                                    str(MLP_EVAL_ENVS)])
    eff, counted = out['effective'], out['kernel_launches']
    if (eff['cfg'], eff['num_envs'], eff['rollout_len'], eff['eval_envs'],
            eff['seed'], eff['encoder'], eff['encoder_operands']) != (
            'hlg', MLP_ENVS, 50, MLP_EVAL_ENVS, 111, 'mlp', 'f32'):
        raise AssertionError(f'the run was not the recipe: {eff}')
    none = {'segment_mean': 0, 'segment_mean_backward': 0}
    if counted != none or out['iteration_kernel_launches'] != {
            part: none for part in ('collect', 'update', 'eval')}:
        raise AssertionError(f'the MLP encoder launched {counted} / '
                             f'{out["iteration_kernel_launches"]}')
    if out['episodes'] < 1:
        raise AssertionError('no episode ended in the MLP collect')
    if not all(np.isfinite(v) for v in (*out['losses'].values(),
                                        out['eval_reward'],
                                        *out['eval_channels'].values())):
        raise AssertionError(f'non-finite MLP losses or eval: '
                             f'{out["losses"]} {out["eval_reward"]} '
                             f'{out["eval_channels"]}')
    return out


def two_phase_train_export(dev):
    """The path of grid's two-phase run: the parity recipe's CLI
    (tools/parity_run.py --cfg grid --separate_train) at TP_ENVS envs x
    the phase's 60 steps, 4 epochs of minibatch 256, TP_EVAL_ENVS greedy
    eval envs, seed 111, one iteration a phase, in two chunks: the
    first's --deadline cuts it at phase 2's first iteration, after the
    freeze (final.pt in phase 2 with iteration 0 and the warm-started
    parameters); the second resumes it there and runs phase 2's iteration
    1. Each part of each iteration must launch exactly rollout_len x
    layers forward kernels in collect and eval and minibatch steps x
    layers of each kernel in the update, and nothing else over the two
    chunks; the resume must start on final.pt's parameters, and every
    phase-2 parameter but the land-use head's must move; each stats line
    names its phase, and the road phase's times its road reward. Then
    tools/export_best_plan on phase 2's best.pt: the frozen land use with
    the roads of the best greedy road episode, host-scored with every
    weight, and the host's road term within TOL_EXPORT_ROAD of the jit
    road R_eval. Runs in a TAIL child."""
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl import trainer as trainer_mod
    from urban_tpu_torch.tools import export_best_plan, parity_run
    with tempfile.TemporaryDirectory() as root:
        stats = os.path.join(root, 'stats.jsonl')
        flags = ['--root_dir', root, '--stats', stats, '--cfg', 'grid',
                 '--separate_train', '--num_envs', str(TP_ENVS),
                 '--eval_envs', str(TP_EVAL_ENVS), '--rollout_len',
                 str(TWO_PHASE_LEN), '--device', str(dev)]
        models = os.path.join(root, 'grid', '111', 'models')
        entries = []
        torch.cuda.reset_peak_memory_stats(dev)
        segment_ops.reset_launches()
        t0 = time.time()
        with entry_states(entries):
            first = parity_run.main(['--iterations', '1', '--deadline',
                                     '1e-3', *flags])
            cut = trainer_mod.read_checkpoint(os.path.join(models,
                                                           'final.pt'))
            second = parity_run.main(['--iterations', '1', '--resume',
                                      os.path.join(models, 'final.pt'),
                                      *flags])
        torch.cuda.synchronize(dev)
        counted = dict(segment_ops.launches)
        seconds = time.time() - t0
        with open(stats) as f:
            lines = [json.loads(line) for line in f]
        its = [x for x in lines if 'summary' not in x]
        if (first['iterations'], first['phase'], second['iterations'],
                second['phase']) != ([0], 2, [1], 2) or not (
                first['stopped_at_deadline'] and cut['phase'] == 2
                and cut['iteration'] == 0):
            raise AssertionError(f'chunks {first["iterations"]} / '
                                 f'{second["iterations"]}, phases '
                                 f'{first["phase"]} / {second["phase"]}, '
                                 f'cut at {cut["phase"]}, '
                                 f'{cut["iteration"]}')
        warm = second['warm_start']
        if warm != first['warm_start'] or not warm or warm[0] != warm[1]:
            raise AssertionError(f'warm starts {first["warm_start"]} / '
                                 f'{warm}')
        if [x['phase'] for x in its] != [1, 2] or 'road_reward_s' in its[
                0] or its[1]['road_reward_calls']['collect'] < 1:
            raise AssertionError(f'stats lines {its}')
        (entry,) = entries[1:]
        if entry['iteration'] != 1 or entry['adam'] or any(
                not torch.equal(v, cut['params'][k])
                for k, v in entry['params'].items()):
            raise AssertionError('the resume did not start on final.pt')
        phase2 = trainer_mod.read_checkpoint(os.path.join(
            models, 'phase2_final.pt'))
        # the road phase plans no land use: the land-use head's gradient is
        # exactly zero, and Adam leaves it as it was
        unchanged = sorted(k for k, v in phase2['params'].items()
                           if torch.equal(v, entry['params'][k]))
        if any(not k.startswith('land_use_head.') for k in unchanged):
            raise AssertionError(f'phase-2 parameters the update left as '
                                 f'they were: {unchanged}')
        with tempfile.TemporaryDirectory() as cfg_root:
            cfg = trainer_mod.Config('grid', 111, root_dir=cfg_root)
        layers = cfg.state_encoder_specs['num_gcn_layers']
        mb_layers = cfg.num_optim_epoch * (
            TP_ENVS * TWO_PHASE_LEN // cfg.mini_batch_size) * layers
        forward = {'segment_mean': TWO_PHASE_LEN * layers,
                   'segment_mean_backward': 0}
        expect = {'collect': forward, 'update': {
            'segment_mean': mb_layers, 'segment_mean_backward': mb_layers},
            'eval': forward}
        total = {k: 2 * sum(p[k] for p in expect.values()) for k in counted}
        got = [x['kernel_launches'] for x in its]
        if got != [expect] * 2 or counted != total:
            raise AssertionError(f'two-phase launches {got} / {counted} != '
                                 f'{expect} / {total}')

        t1 = time.time()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = export_best_plan.main([
                '--cfg', 'grid', '--ckpt', os.path.join(models, 'best.pt'),
                '--out', os.path.join(root, 'best.geojson')])
        out = printed.getvalue().splitlines()
        if rc != 0 or not out[-1].startswith('road: '):
            raise AssertionError(f'export: rc {rc}, {out}')
        host = float(out[1].split(': ')[1])
        road_host, road_jit = (float(x) for x in out[-1][len('road: '):-1]
                               .split(' (jit '))
        if not (np.isfinite(host) and abs(road_host - road_jit)
                <= TOL_EXPORT_ROAD):
            raise AssertionError(f'export: host {host}, road {road_host} '
                                 f'against jit {road_jit}')
        export = {'rc': rc, 'printed': out[0], 'host_reward': host,
                  'host_road': road_host, 'jit_road': road_jit,
                  'seconds': time.time() - t1}
    return {'effective': second['effective'], 'seconds': seconds,
            'chunks': [{k: c[k] for k in (
                'iterations', 'phase', 'phase1', 'warm_start',
                'stopped_at_deadline', 'best_reward', 'best_iteration',
                'wall_s', 'peak_allocated_bytes')} for c in (first, second)],
            'iterations': [{k: x[k] for k in (
                'iteration', 'phase', 'sample_time', 'update_time',
                'eval_time', 'episodes', 'failures', 'mean_episode_reward',
                'eval_reward', 'peak_allocated_bytes')} | {
                'road_reward_s': x.get('road_reward_s')} for x in its],
            'iteration_kernel_launches': got, 'kernel_launches': counted,
            'unchanged_parameters': unchanged, 'export': export}


def trainer_card_vs_cpu(dev, encoder, cfg_id='hlg', encoder_specs=None,
                        ref_threads=None, phase=1, rollout_len=TRAIN_LEN):
    """tools/card_lockstep.py: the trainer on scenario `cfg_id` with the
    state encoder `encoder` on the card (eager=True) against the same
    trainer on the
    CPU (in a spawned process meanwhile), from the same initial draw, on
    the same served noise, through LOCKSTEP_ITERATIONS iterations of
    collect -> weights -> update -> eval and one more collect at
    LOCKSTEP_ENVS envs x TRAIN_LEN steps: every check of the tool must
    hold (actions, dones and failures equal, floats within rtol 1e-5 /
    atol 1e-4, losses within 1e-4, parameters within 4e-5 an Adam step,
    Adam's steps, the eval and the best plan's iteration). The card's
    launches must be exact: TRAIN_LEN x layers forward in each collect
    and eval, minibatch steps x layers of each kernel in each update; the
    MLP none. Runs in a TAIL child, one an arm (the SGNN and the MLP on
    HLG, the SGNN on hlg_concept: E 4000, the forward's split plan at B 8
    and 2 and its unstaged plan at the update's B 256, the backward's
    tile-16 plan, the concept term in the rewards compared; the SGNN on
    HLG with its state_encoder_specs updated with `encoder_specs`; the
    SGNN in grid's road phase, `phase` 2, both sides frozen on one plan
    with one warm start, at the phase's `rollout_len` of 60 steps). The
    CPU side runs on `ref_threads` intra-op threads (CHILD_THREADS where
    not given)."""
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.tools import card_lockstep
    segment_ops.reset_launches()
    report = card_lockstep.run(
        str(dev), 'cpu', concurrent=True,
        ref_threads=ref_threads or CHILD_THREADS,
        encoder=encoder, cfg=cfg_id, num_envs=LOCKSTEP_ENVS,
        rollout_len=rollout_len,
        eval_envs=LOCKSTEP_EVAL_ENVS, iterations=LOCKSTEP_ITERATIONS,
        encoder_specs=encoder_specs, phase=phase)
    torch.cuda.synchronize(dev)
    counted = dict(segment_ops.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not report['ok']:
        raise AssertionError(f'trainer card vs cpu ({cfg_id}, {encoder}): '
                             f'{report["failures"][:20]}')
    with tempfile.TemporaryDirectory() as root:
        cfg = Config(cfg_id, 111, root_dir=root)
    layers = (cfg.state_encoder_specs['num_gcn_layers']
              if encoder == 'sgnn' else 0)
    rows = LOCKSTEP_ENVS * rollout_len
    mb_layers = cfg.num_optim_epoch * max(
        rows // cfg.mini_batch_size, 1) * layers
    forward = {'segment_mean': rollout_len * layers,
               'segment_mean_backward': 0}
    expect = {'collect': forward, 'update': {
        'segment_mean': mb_layers, 'segment_mean_backward': mb_layers},
        'eval': forward}
    total = {k: LOCKSTEP_ITERATIONS * sum(p[k] for p in expect.values())
             + forward[k] for k in counted}
    got = [it['launches'] for it in report['iterations']]
    if (got != [expect] * LOCKSTEP_ITERATIONS or counted != total
            or report['last_collect_launches'] != forward):
        raise AssertionError(f'lockstep launches {got}, last collect '
                             f'{report["last_collect_launches"]}, counted '
                             f'{counted} != {expect}, {total}')
    if phase == 2 and (report['phase'] != 2 or not report['warm_start']
                       or report['warm_start'][0] != report['warm_start'][1]):
        raise AssertionError(f'the road phase did not run warm-started: '
                             f'{report["phase"]}, {report["warm_start"]}')
    arm = encoder if cfg_id == 'hlg' else f'{cfg_id}_{encoder}'
    return {'arm': arm if phase == 1 else f'{cfg_id}_phase2_{encoder}',
            'encoder': encoder, 'phase': report['phase'],
            'warm_start': report['warm_start'], 'sizes': report['sizes'],
            'widths': report['widths'],
            'plans': report['plans'],
            'per_iteration': [{k: it[k] for k in (
                'adam_steps', 'parameter_bound', 'group_max_abs_diff',
                'loss_abs_diff', 'eval_reward', 'episodes', 'failures',
                'launches')} for it in report['iterations']],
            'collects': report['collects'],
            'sides_seconds': report['seconds'], 'kernel_launches': counted,
            'peak_allocated_gb': peak_gb}


def trainer_card_vs_cpu_sgnn(dev):
    return trainer_card_vs_cpu(dev, 'sgnn')


def trainer_card_vs_cpu_mlp(dev):
    return trainer_card_vs_cpu(dev, 'mlp')


def trainer_card_vs_cpu_concept(dev):
    return trainer_card_vs_cpu(dev, 'sgnn', 'hlg_concept')


def trainer_card_vs_cpu_wide(dev):
    return trainer_card_vs_cpu(dev, 'sgnn', encoder_specs=WIDE_SPECS,
                               ref_threads=WIDE_REF_THREADS)


def trainer_card_vs_cpu_phase2(dev):
    return trainer_card_vs_cpu(dev, 'sgnn', 'grid', phase=2,
                               rollout_len=TWO_PHASE_LEN)


def trainer_card_vs_cpu_dhm(dev):
    return trainer_card_vs_cpu(dev, 'sgnn', 'dhm')


def ga_graph_vs_eager(dev):
    """make_ga_population_fitness on HLG (GA_CMP_GENES genes, GA_STEPS
    steps) through its captured 'ga' step program against the same
    program stepped eagerly, from one seed: greedy once and sampled twice
    (the one generator reseeded before each call): equal fitness, and no
    kernel launch. The seconds of each call, a GA generation's fitness.
    Runs in a TAIL child."""
    from urban_tpu_torch import bench
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl.ga import make_ga_population_fitness
    _, spec, init = bench.setup('hlg', {}, 'cpu')
    genes = np.random.default_rng(0).uniform(-5, 5,
                                             size=(GA_CMP_GENES, 47))
    segment_ops.reset_launches()
    runs = {}
    for mean_action, calls in ((True, 1), (False, 2)):
        for mode in ('graph', 'eager'):
            fit = make_ga_population_fitness(
                spec, init, GA_STEPS, mean_action=mean_action, seed=0,
                device=dev, eager=mode == 'eager')
            fitness, seconds = [], []
            for _ in range(calls):
                t = time.time()
                fitness.append(fit(genes))
                seconds.append(time.time() - t)
            (program,) = fit.programs.values()
            runs['greedy' if mean_action else 'sampled', mode] = {
                'fitness': fitness, 'seconds': seconds,
                'graphed': program.graph is not None,
                'program': bench.program_stats(program)}
    checks = {}
    for kind in ('greedy', 'sampled'):
        g, e = runs[kind, 'graph'], runs[kind, 'eager']
        checks[kind] = (g['graphed'] and not e['graphed'] and all(
            np.array_equal(a, b) for a, b in zip(g['fitness'],
                                                 e['fitness'])))
    launches = dict(segment_ops.launches)
    if not (all(checks.values()) and not any(launches.values())
            and (runs['greedy', 'graph']['fitness'][0] > 0).any()):
        raise AssertionError(f'GA graph vs eager: {checks}, launches '
                             f'{launches}')
    return {'genes': GA_CMP_GENES, 'steps': GA_STEPS, 'checks': checks,
            'kernel_launches': launches,
            'fitness': {f'{k}_{m}': [f.tolist() for f in r['fitness']]
                        for (k, m), r in runs.items()},
            'seconds_per_generation': {f'{k}_{m}': r['seconds']
                                       for (k, m), r in runs.items()},
            'program': runs['sampled', 'graph']['program']}


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


def grid_phase1_setup():
    """(spec, initial state on the CPU) of the grid's two-phase land-use
    phase, as run_training builds them: cfg.train(), the BOUNDARY segments
    kept, the trainer's default caps."""
    from urban_tpu_torch.host.envs.plan_client import PlanClient
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.torchenv import state as tstate
    with tempfile.TemporaryDirectory() as root:
        cfg = Config('grid', 111, root_dir=root)
    cfg.train()
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = tstate.build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length,
                                 keep_boundaries=True)
    return spec, tstate.build_initial_state(spec, plc, device='cpu')


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


def bf16_operands_card_vs_cpu(cfg, spec, obs, actions, log_probs, dev,
                               layers):
    """The SGNN with encoder_operands='bf16' (the JAX encoder's default
    numerics: bf16-rounded gather and segment-mean operands, f32 sums)
    from JAX's HLG initial parameters, on real HLG states at the
    trainer's caps, card vs CPU: the forward (the forward kernel launched
    `layers` times on the rounded values) and one PPO loss gradient (the
    backward kernel too). The rounding flips where the card's and the
    CPU's f32 sums straddle a bf16 boundary, so the bounds are the
    option's: the mean logit gap card vs CPU under a tenth of the gap
    between the bf16 and the f32 encoder on the card, at most 1% of the
    legal logits off by more than TOL_MODEL, the value within 1e-3, the
    gradient's difference under 1% of its norm."""
    import copy
    from urban_tpu_torch.models.convert import load_flax_npz
    from urban_tpu_torch.models.model import create_model
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl.ppo import PPOConfig, ppo_loss
    models = {}
    for operands in ('bf16', 'f32'):
        m = load_flax_npz(create_model(cfg, spec.num_features, spec.NE,
                                       encoder_operands=operands), JAX_INIT)
        models[operands] = (m, copy.deepcopy(m).to(dev))
    obs_cpu = tuple(o.cpu() for o in obs)
    obs_dev = tuple(o.to(dev) for o in obs)
    segment_ops.reset_launches()
    with torch.no_grad():
        lu_g, _, _, v_g = models['bf16'][1](obs_dev)
        torch.cuda.synchronize(dev)
        launches = dict(segment_ops.launches)
        lu_f, _, _, _ = models['f32'][1](obs_dev)
        lu_c, _, _, v_c = models['bf16'][0](obs_cpu)
    legal = obs_cpu[6]
    d = (lu_g.cpu() - lu_c)[legal].abs()
    option = (lu_g - lu_f).cpu()[legal].abs()
    rng = np.random.default_rng(5)
    B = actions.shape[0]
    returns, adv = (torch.as_tensor(rng.normal(size=(B, 1)),
                                    dtype=torch.float32) for _ in range(2))
    ones = torch.ones(B)
    grads = {}
    for where, m, o in (('card', models['bf16'][1], obs_dev),
                        ('cpu', models['bf16'][0], obs_cpu)):
        d_ = o[0].device
        loss, _ = ppo_loss(m, o, actions.to(d_), returns.to(d_), adv.to(d_),
                           log_probs[:, None].to(d_), ones.to(d_),
                           PPOConfig(), ones.to(d_))
        loss.backward()
        grads[where] = torch.cat([p.grad.cpu().reshape(-1)
                                  for p in m.parameters()])
    rec = {'states': B, 'graph': [spec.NE, spec.num_features],
           'forward_launches': launches,
           'logit_mean_abs_diff': float(d.mean()),
           'logit_max_abs_diff': float(d.max()),
           'logits_over_tol': float((d > TOL_MODEL).float().mean()),
           'value_max_abs_diff': float((v_g.cpu() - v_c).abs().max()),
           'bf16_vs_f32_logit_mean_abs_diff': float(option.mean()),
           'grad_rel_diff': float((grads['card'] - grads['cpu']).norm()
                                  / grads['cpu'].norm())}
    if not (launches == {'segment_mean': layers, 'segment_mean_backward': 0}
            and rec['logit_mean_abs_diff'] * 10
            < rec['bf16_vs_f32_logit_mean_abs_diff']
            and rec['logits_over_tol'] <= 0.01
            and rec['value_max_abs_diff'] <= 1e-3
            and rec['grad_rel_diff'] < 1e-2):
        raise AssertionError(f'bf16 encoder operands card vs cpu: {rec}')
    return rec


def policy_graph_vs_eager(calls, model_cpu, dev, layers):
    """The host agent's policy step (`calls`: (obs, seed, mean_action)
    in the order the train CLI took them) replayed through the captured
    program and stepped eagerly, with one model on the card (a copy of
    `model_cpu`): every action equal; the seconds a step of each (the
    program's first call, which captures, apart); one profiler trace of a
    replay, which must hold `layers` forward kernel events. Then other
    parameters written in place (`load_state_dict` of a fresh draw, as a
    checkpoint or an update writes them): over POLICY_RELOAD_STEPS calls
    the same program, not captured again, equals the eager select, and
    some of its actions move."""
    import copy
    from urban_tpu_torch import kernel_bench as kb
    from urban_tpu_torch.agents.policy_program import (eager_select,
                                                       graphed_select)
    from urban_tpu_torch.models.model import init_like_flax
    model = copy.deepcopy(model_cpu).to(dev)
    graphed, eager = graphed_select(model, dev), eager_select(model, dev)
    acts, seconds = {}, {}
    t = time.perf_counter()
    first = graphed(*calls[0])
    capture_s = time.perf_counter() - t
    for name, select in (('graph', graphed), ('eager', eager)):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        acts[name] = [select(*c) for c in calls[1:]]
        seconds[name] = (time.perf_counter() - t) / (len(calls) - 1)
    acts['graph'].insert(0, first)
    acts['eager'].insert(0, eager(*calls[0]))
    differ = [i for i, (a, b) in enumerate(zip(acts['graph'],
                                               acts['eager']))
              if not np.array_equal(a, b)]
    (program,) = graphed.programs.values()
    trace = kb.one_trace(program.graph.replay, kb.FORWARD_KERNEL, reps=1)
    ptrs = [p.data_ptr() for p in model.parameters()]
    model.load_state_dict(init_like_flax(
        copy.deepcopy(model_cpu), torch.Generator().manual_seed(1))
        .state_dict())
    reload = calls[:POLICY_RELOAD_STEPS]
    after = [(graphed(*c), eager(*c)) for c in reload]
    reload_differ = [i for i, (a, b) in enumerate(after)
                     if not np.array_equal(a, b)]
    moved = sum(not np.array_equal(b, a)
                for (_, b), a in zip(after, acts['eager']))
    rec = {'steps': len(calls), 'differ': differ,
           'sampled_steps': sum(not c[2] for c in calls),
           'stages': sorted({int(np.argmax(c[0][-1][0])) for c in calls}),
           'policy_s_per_step': seconds, 'first_call_s': capture_s,
           'warmup_s': program.warmup_seconds,
           'capture_s': program.capture_seconds,
           'replay_launches': program.launches, 'replay_trace': trace,
           'reload': {'steps': len(reload), 'differ': reload_differ,
                      'actions_moved': moved,
                      'programs': len(graphed.programs),
                      'in_place': ptrs == [p.data_ptr()
                                           for p in model.parameters()]}}
    if differ or len(calls) < 500 or trace['kernel_events'] != layers \
            or program.launches['segment_mean'] != layers \
            or reload_differ or not moved or not rec['reload']['in_place'] \
            or list(graphed.programs.values()) != [program]:
        raise AssertionError(f'host policy graph vs eager: {rec}')
    return rec


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
    pol = {'steps': 0, 'seconds': 0.0, 'trace': None, 'calls': []}
    parts, rec = [], {'road_rewards': [], 'eval_rewards': {}}

    def select_fn(self):
        inner = orig['select_fn'](self)

        def select(obs, seed, mean_action):
            t = time.perf_counter()
            a = inner(obs, seed, mean_action)
            pol['seconds'] += time.perf_counter() - t
            pol['steps'] += 1
            if pol['trace'] is None and len(pol['calls']) < POLICY_STEPS:
                pol['calls'].append((tuple(np.array(o) for o in obs),
                                     int(seed), bool(mean_action)))
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
            rec['policy_graph_vs_eager'] = policy_graph_vs_eager(
                pol['calls'], ev.model, dev, layers)
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
        ('divergence_side', 'cpu'), ('train_graph_vs_eager', 'cuda'),
        ('ga_graph_vs_eager', 'cuda'), ('train_resume_export_hlg', 'cuda'),
        ('huizhou_train_export', 'cuda'), ('mlp_train_hlg', 'cuda'),
        ('concept_train_export', 'cuda'),
        ('trainer_card_vs_cpu_sgnn', 'cuda'),
        ('trainer_card_vs_cpu_mlp', 'cuda'),
        ('trainer_card_vs_cpu_concept', 'cuda'),
        ('trainer_card_vs_cpu_wide', 'cuda'),
        ('train_graph_vs_eager_wide', 'cuda'),
        ('two_phase_train_export', 'cuda'),
        ('trainer_card_vs_cpu_phase2', 'cuda'),
        ('trainer_card_vs_cpu_dhm', 'cuda'))
# the TAIL phases that train: their launches go into the kernels' counts
LOCKSTEP_TAIL = ('trainer_card_vs_cpu_sgnn', 'trainer_card_vs_cpu_mlp',
                 'trainer_card_vs_cpu_concept',
                 'trainer_card_vs_cpu_phase2',
                 'trainer_card_vs_cpu_dhm')   # printed as one phase
TRAIN_TAIL = ('train_resume_export_hlg', 'huizhou_train_export',
              'mlp_train_hlg', 'concept_train_export') + LOCKSTEP_TAIL + (
              'trainer_card_vs_cpu_wide', 'train_graph_vs_eager_wide',
              'two_phase_train_export')
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
    GA, the failure replay, the divergence replay card vs CPU, the graphs
    against eager steps, the parity recipe's resume and export): with
    `concurrent`, each TAIL phase in a child process (those not yet in
    `children` started here) beside the graft entry points, else each in
    this process, one after another. Prints each phase with its own
    seconds, then the tail's wall seconds; returns the failure replay's
    record and the records of the TRAIN_TAIL phases, by name."""
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
    for name in ('train_graph_vs_eager', 'ga_graph_vs_eager') + TRAIN_TAIL:
        if name not in LOCKSTEP_TAIL:
            secs, rec = got[f'{name}:cuda']
            phase(name, time.time() - secs, **rec)
    arms = {got[f'{name}:cuda'][1]['arm']: got[f'{name}:cuda']
            for name in LOCKSTEP_TAIL}
    phase('trainer_card_vs_cpu', time.time() - max(
        secs for secs, _ in arms.values()),
        **{arm: dict(rec, seconds=secs)
           for arm, (secs, rec) in arms.items()})
    (s_card, card), (s_cpu, cpu) = got['divergence_side:cuda'], \
        got['divergence_side:cpu']
    phase('divergence_card_vs_cpu', time.time() - s_card - s_cpu,
          **divergence_card_vs_cpu(card, cpu),
          sides_seconds={'cuda': s_card, 'cpu': s_cpu})
    phase('tail', t_tail, concurrent=concurrent,
          phase_seconds={key: got[key][0] for key in got})
    return replay, {name: got[f'{name}:cuda'][1] for name in TRAIN_TAIL}


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

    # ---- 2b. the launch plans on this card's limits ----------------------
    t0 = time.time()
    limits = segment_ops.device_limits(dev)
    plans = kb.plans_under(segment_ops, limits)
    phase('launch_plans', t0, device_limits=limits._asdict(),
          reserved_bytes=limits.reserved_bytes,
          h100_sxm_limits=limits == segment_ops.H100_SXM,
          same_plans_as_h100_sxm=plans == kb.plans_under(
              segment_ops, segment_ops.H100_SXM),
          plans={k: {'forward': f, 'backward': b}
                 for k, (f, b) in plans.items()})

    # ---- 3. the kernels against their plain versions --------------------
    # the forward and the backward at every shape of kb.SHAPES, on a random
    # bipartite graph (timed) and on a scenario's initial observation: HLG
    # at the rollout's and the trainer's size, grid at its trainer's and
    # its land-use phase's, hlg_concept at the concept trainer's, Huizhou
    # and DHM at their trainers'
    t0 = time.time()
    cfg, spec, init_cpu = bench.setup('hlg', bench.BENCH_CAPS, 'cpu')
    obs0 = make_batch_fns(spec)[0](broadcast_state(init_cpu, 1))
    cfg_t, spec_t, init_t = bench.setup('hlg', {}, 'cpu')  # trainer caps
    N_T, E_T = spec_t.num_features, spec_t.NE
    obs_t = make_batch_fns(spec_t)[0](broadcast_state(init_t, 1))
    cfg_g, spec_g, init_g_cpu = bench.setup('grid', {}, 'cpu')  # trainer caps
    _, spec_c, init_c = bench.setup('hlg_concept', {}, 'cpu')
    _, spec_h, init_h = bench.setup('huizhou', {}, 'cpu')   # trainer caps
    spec_p1, init_p1 = grid_phase1_setup()
    real_obs = {
        'rollout': ('hlg_initial_observation', obs0),
        'trainer': ('hlg_initial_observation', obs_t),
        'grid_trainer': ('grid_initial_observation', make_batch_fns(
            spec_g)[0](broadcast_state(init_g_cpu, 1))),
        'concept': ('hlg_concept_initial_observation', make_batch_fns(
            spec_c)[0](broadcast_state(init_c, 1))),
        'host_obs': ('grid_host_env_initial_observation',
                     host_obs_tensors()),
        'huizhou_trainer': ('huizhou_initial_observation', make_batch_fns(
            spec_h)[0](broadcast_state(init_h, 1))),
        'grid_phase1': ('grid_phase1_initial_observation', make_batch_fns(
            spec_p1)[0](broadcast_state(init_p1, 1)))}
    fwd, bwd, fwd_err, bwd_err = check_kernels(kb, segment_ops, dev,
                                               real_obs, t0)
    # DHM's trainer graph has grid_phase1's shape (3000, 1408, 16): its
    # initial observation through both kernels at that shape's batches
    # (the recipe's update and collect at 256, its eval at 64)
    _, spec_d, init_d = bench.setup('dhm', {}, 'cpu')   # trainer caps
    _, _, e_f, e_b = check_kernels(
        kb, segment_ops, dev, {'grid_phase1': (
            'dhm_initial_observation', make_batch_fns(spec_d)[0](
                broadcast_state(init_d, 1)))}, t0,
        shapes=[s for s in kb.SHAPES if s[0] == 'grid_phase1'],
        random_graphs=False)
    fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)

    # ---- 3b. the kernels at the range shapes ---------------------------
    # the widths and graphs past the shipped scenarios (kb.RANGE_SHAPES:
    # gcn_node_dim 24, 128 and 6, max_num_edges 40000, a graph of 40,000
    # nodes at widths 16 and 24), with the checks of phase 3; then the general plan forced at
    # the HLG and Huizhou trainer graphs against the plan chosen there, and
    # the runtime-width instantiation against the templated one, bit for bit
    t0 = time.time()
    f_r, b_r, e_f, e_b = check_kernels(kb, segment_ops, dev, {}, t0,
                                       shapes=kb.RANGE_SHAPES)
    fwd.update(f_r)
    bwd.update(b_r)
    fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    rng = np.random.default_rng(1)
    forced = kb.general_vs_chosen(segment_ops, rng, dev)
    widths = kb.any_width_vs_templated(segment_ops, rng, dev)
    if not all(r['same_bits'] for r in forced + widths):
        raise AssertionError(f'plans differ in bits: {forced} {widths}')
    torch.cuda.empty_cache()
    phase('range_kernels', t0, shapes=[list(s) for s in kb.RANGE_SHAPES],
          general_vs_chosen=forced, any_width_vs_templated=widths)
    # the wide lockstep (gcn_node_dim 24, 40,000 edge slots) from here on:
    # its CPU side updates on 256 rows of 40,000 edges for 11-14 minutes on
    # 2 threads (WIDE_REF_THREADS here), the longest child; its card side's
    # memory is given back after 80-110 s
    children['trainer_card_vs_cpu_wide:cuda'] = start_child(
        'trainer_card_vs_cpu_wide', 'cuda')

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

    # ---- 4b'. the bf16 encoder operands on the card vs the CPU ----------
    t0 = time.time()
    phase('bf16_operands_card_vs_cpu', t0, **bf16_operands_card_vs_cpu(
        cfg_t, spec_t, obs_mb, traj.actions[1], traj.log_probs[1], dev,
        model_cpu.num_gcn_layers))

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

    # ---- 5b. the captured graph against the eager loop -----------------
    t0 = time.time()
    gve = rollout_graph_vs_eager(bench, kb, segment_ops, dev, B, layers)
    torch.cuda.empty_cache()
    phase('rollout_graph_vs_eager', t0, **gve)
    # the divergence replay's CPU side (one core, no card) from here on,
    # after the rollout whose env steps/s is the host's yardstick; so the
    # hlg_concept arm of the card-vs-CPU trainer lockstep (three cores: its
    # card side, a CPU side of two threads), whose ~300 s in the tail beside
    # fifteen other children would lengthen the tail by ~120 s
    children['divergence_side:cpu'] = start_child('divergence_side', 'cpu')
    children['trainer_card_vs_cpu_concept:cuda'] = start_child(
        'trainer_card_vs_cpu_concept', 'cuda')
    # so the wide graph-vs-eager, whose updates at 256 rows of 40,000 edges
    # (a captured graph's pool, then eager) would add their peak to the
    # tail's sixteen children on the card
    children['train_graph_vs_eager_wide:cuda'] = start_child(
        'train_graph_vs_eager_wide', 'cuda')
    # so the road phase's lockstep, whose CPU side steps 8 grid envs
    # through 5 windows of 60 steps on 2 threads
    children['trainer_card_vs_cpu_phase2:cuda'] = start_child(
        'trainer_card_vs_cpu_phase2', 'cuda')

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
        # the same collect stepped eagerly, from the trainer's states and
        # generator state: the graphed collect must take its actions
        gen = torch.Generator(device=dev)
        gen.set_state(trainer.generator.get_state())
        torch.cuda.synchronize(dev)
        t_eager = time.perf_counter()
        _, traj = rollout(trainer.spec, trainer.model, trainer.init_state,
                          trainer.env_states, gen, TRAIN_LEN, eager=True)
        eager_actions = traj.actions.cpu().numpy()
        t_eager = time.perf_counter() - t_eager
        del traj
        update_args, graph_epochs = [], []
        with keeping_update(trainer, update_args, graph_epochs):
            train = bench.measure_train_iteration(trainer)  # resets counts
        if not np.array_equal(trainer.last_actions, eager_actions):
            raise AssertionError('the graphed collect\'s actions are not the '
                                 'eager collect\'s')
        train['t_sample_eager_s'] = t_eager
        train_launches = train['kernel_launches']
        mb_layers = train['update_minibatch_steps'] * layers
        expect = {'segment_mean': TRAIN_LEN * layers + mb_layers,
                  'segment_mean_backward': mb_layers}
        if train_launches != expect:
            raise AssertionError(f'train kernel launches {train_launches} '
                                 f'!= {expect}')
        if not all(np.isfinite(v) for v in train['losses'].values()):
            raise AssertionError(f'non-finite loss stats {train["losses"]}')
        # HLG plans land use only (skip_road): everything but the road head
        # moves
        unchanged = unmoved_parameters(
            dict(trainer.model.named_parameters()), before)
        if train['episodes'] < 1:
            raise AssertionError('no episode ended in the train rollout')
        if not train['overflow_gate_1pct_pass']:
            raise AssertionError(f'capacity gate: {train}')
        phase('train', t0, unchanged_parameters=unchanged, **train)

        # ---- 7b. the update's captured graph against the eager loop ----
        t0 = time.time()
        uge = update_graph_vs_eager(bench, kb, trainer, update_args,
                                    graph_epochs, train, layers, run_dir,
                                    'hlg', profile=True)
        del update_args, graph_epochs
        torch.cuda.empty_cache()
        phase('update_graph_vs_eager', t0, **uge)

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
        update_args, graph_epochs = [], []
        try:
            with keeping_update(trainer, update_args, graph_epochs):
                grid = bench.measure_train_iteration(trainer)  # resets
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

        # the grid update's graph against the eager loop (no profile)
        t0 = time.time()
        guge = update_graph_vs_eager(bench, kb, trainer, update_args,
                                     graph_epochs, grid, layers, run_dir,
                                     'grid', profile=False)
        del update_args, graph_epochs
        torch.cuda.empty_cache()
        phase('grid_update_graph_vs_eager', t0, **guge)

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

    # the DHM arm of the card-vs-CPU trainer lockstep from here on (three
    # cores: its card side, a CPU side of two threads), once the arms
    # started after the HLG rollout have had the host for the train phases
    children['trainer_card_vs_cpu_dhm:cuda'] = start_child(
        'trainer_card_vs_cpu_dhm', 'cuda')

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
          policy_graph_vs_eager=host['policy_graph_vs_eager'],
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
    replay, trained = tail(dev, children)

    phase('total', t_start, hlg_rollout_env_steps_per_sec=stats[
        'env_steps_per_sec'], hlg_rollout_eager_env_steps_per_sec=gve[
        'env_steps_per_sec']['eager'])
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
         + replay['kernel_launches']['segment_mean']
         + sum(t['kernel_launches']['segment_mean']
               for t in trained.values()), fwd_err, fwd[shape]),
        ('segment_mean_backward',
         'none: no TPU counterpart (the Pallas segment-mean kernels of '
         'urban_tpu/ops/pallas/segment_ops.py have no gradient)',
         train_launches['segment_mean_backward']
         + grid_launches['segment_mean_backward']
         + two_launches['segment_mean_backward']
         + host_launches['segment_mean_backward']
         + dp['kernel_launches']['segment_mean_backward']
         + sum(t['kernel_launches']['segment_mean_backward']
               for t in trained.values()), bwd_err, bwd[shape]),
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
