"""Smoke run of the PyTorch/CUDA port (urban_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the two CUDA kernels from the sources in the checkout (one nvcc per
source, all at once) and checks each against its plain PyTorch version at
the shapes of the main paths: the forward segment mean, which every path
runs, and its backward, which the PPO update runs, each at the rollout's,
the trainer's and a large graph's size, timed beside one PyTorch library
call and its memory bound (urban_tpu_torch/kernel_bench.py). The backward
must give the plain version's bits, on the card and on the CPU.
Runs the SGNN policy on the card against the same model on the CPU, and
one PPO loss backward on the card against the CPU. Drives the batched HLG
rollout (256 envs x 30 steps), steps GPU and CPU environments in lockstep,
then runs one full HLG PPO train_iteration (256 envs x 50 steps, 4 epochs
of minibatch 256) and a 16-env greedy evaluation, showing from the launch
counts that each path went through its kernels. One line per phase; the
line before the last is one JSON object describing each kernel, the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or any check fails. About 5 minutes on an
H100.
"""
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
ROLLOUT_STEPS, TRAIN_ENVS, TRAIN_LEN, EVAL_ENVS = 30, 256, 50, 16


def phase(name, t0, **kv):
    print(json.dumps({'phase': name, 'seconds': round(time.time() - t0, 3),
                      **kv}), flush=True)


def check_kernels(kb, segment_ops, dev, hlg_obs, t0):
    """Phase 3: the forward and the backward kernel against their plain
    versions at every shape of kb.SHAPES, timed on the random graphs.
    Returns the times by shape and the largest errors; the inputs, some of
    them GB, are freed on return, before the paths whose memory is
    measured."""
    B = kb.B
    rng = np.random.default_rng(0)
    fwd, bwd, fwd_err, bwd_err = {}, {}, 0.0, 0.0
    for shape, e, n, d in kb.SHAPES:
        graphs = {'random_bipartite_30pct_masked': kb.random_graph(rng, B, e,
                                                                   n)}
        if shape in hlg_obs:
            o = hlg_obs[shape]
            if tuple(o[2].shape[1:2]) + tuple(o[4].shape[1:2]) != (e, n):
                raise AssertionError(f'{shape}: HLG graph is not {(e, n)}')
            graphs['hlg_initial_observation'] = (
                o[2].expand(B, -1, -1).contiguous(),
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
            # rows in edge order, as the kernel does; on the HLG graph
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
                  BEND=[B, e, n, d], max_abs_err=err, bitwise_repeat=True,
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


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port has no CPU '
                         'fallback for this check')

    from urban_tpu_torch import bench
    from urban_tpu_torch import kernel_bench as kb
    from urban_tpu_torch.models.policy import MASK_PAD
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl.ppo import PPOConfig, ppo_loss
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                                  broadcast_state,
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
    # bipartite graph (timed) and, at the rollout's and the trainer's size,
    # on the initial HLG observation
    t0 = time.time()
    cfg, spec, init_cpu = bench.setup('hlg', bench.BENCH_CAPS, 'cpu')
    batch_obs_cpu, batch_step_cpu = make_batch_fns(spec)
    obs0 = batch_obs_cpu(broadcast_state(init_cpu, 1))
    cfg_t, spec_t, init_t = bench.setup('hlg', {}, 'cpu')  # trainer caps
    N_T, E_T = spec_t.num_features, spec_t.NE
    obs_t = make_batch_fns(spec_t)[0](broadcast_state(init_t, 1))
    hlg_obs = {'rollout': obs0, 'trainer': obs_t}
    fwd, bwd, fwd_err, bwd_err = check_kernels(kb, segment_ops, dev, hlg_obs,
                                               t0)

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
    grng = np.random.default_rng(3)
    returns, adv, noise = (torch.as_tensor(grng.normal(size=(B, 1)),
                                           dtype=torch.float32)
                           for _ in range(3))
    exps = torch.as_tensor(grng.random(B) < 0.7, dtype=torch.float32)
    valid = torch.as_tensor(grng.random(B) < 0.8, dtype=torch.float32)
    fixed = traj.log_probs[1][:, None].cpu() + 0.3 * noise
    grads = {}
    for where, model, d in (('card', m_gpu, dev), ('cpu', m_cpu, 'cpu')):
        loss, _ = ppo_loss(model, tuple(o.to(d) for o in obs_mb),
                           traj.actions[1].to(d), returns.to(d), adv.to(d),
                           fixed.to(d), exps.to(d), PPOConfig(), valid.to(d))
        loss.backward()
        grads[where] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    err = {k: float((grads['card'][k] - g).abs().max())
           for k, g in grads['cpu'].items()}
    bound = {k: TOL_GRAD_REL * float(g.abs().max()) + TOL_GRAD_ABS
             for k, g in grads['cpu'].items()}
    edge_fc = {k: float(g.abs().sum()) for k, g in grads['card'].items()
               if '.edge_fc.' in k}
    bad = {k: (e, bound[k]) for k, e in err.items() if not e <= bound[k]}
    if bad or not all(s > 0 for s in edge_fc.values()):
        raise AssertionError(f'PPO gradients card vs cpu: {bad}, edge_fc '
                             f'gradient sums {edge_fc}')
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
    batch_obs_gpu, batch_step_gpu = make_batch_fns(spec)
    s_cpu = broadcast_state(init_cpu, n_env)
    s_gpu = s_cpu.map(lambda x: x.to(dev))
    arng = np.random.default_rng(7)
    agree = 0
    for step in range(n_steps):
        o_cpu = batch_obs_cpu(s_cpu)
        o_gpu = batch_obs_gpu(s_gpu)
        for k in (2, 4, 5, 6, 7):
            if not torch.equal(o_cpu[k], o_gpu[k].cpu()):
                raise AssertionError(f'step {step}: observation {k} differs')
        lu = o_cpu[6].numpy()
        acts = np.array([[int(arng.choice(np.nonzero(lu[b])[0]))
                          if lu[b].any() else 0, 0] for b in range(n_env)],
                        dtype=np.int32)
        a = torch.as_tensor(acts)
        n_cpu, r_cpu, _, i_cpu = batch_step_cpu(s_cpu, a)
        n_cpu, r_cpu = apply_stage_rewards(spec, n_cpu, r_cpu, i_cpu)
        n_gpu, r_gpu, _, i_gpu = batch_step_gpu(s_gpu, a.to(dev))
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
        agree += 1
        s_cpu, s_gpu = n_cpu, n_gpu
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

    phase('total', t_start)
    kernels = [
        ('segment_mean',
         'urban_tpu/ops/pallas/segment_ops.py:61 (segment_mean_pallas) and '
         'urban_tpu/ops/pallas/segment_ops.py:130 '
         '(segment_mean_onehot_pallas)',
         launches['segment_mean'] + train_launches['segment_mean']
         + eval_launches['segment_mean'], fwd_err, fwd['trainer']),
        ('segment_mean_backward',
         'none: no TPU counterpart (the Pallas segment-mean kernels of '
         'urban_tpu/ops/pallas/segment_ops.py have no gradient)',
         train_launches['segment_mean_backward'], bwd_err, bwd['trainer']),
    ]
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'urban_tpu_torch/csrc/{segment_ops.KERNELS[name][0]}',
        'replaces': replaces, 'launches': n, 'max_abs_err': err,
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': 'bytes', 'library_ms': t['library_ms']}
        for name, replaces, n, err, t in kernels]}))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
