"""Smoke run of the PyTorch/CUDA port (urban_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in the checkout, checks it against
its plain PyTorch version at the shapes of the main path, runs the SGNN
policy on the card against the same model on the CPU, drives the batched
HLG rollout (256 envs x 30 steps) and shows that the rollout went through
the kernel, then steps GPU and CPU environments in lockstep. One line per
phase; the line before the last is one JSON object describing each kernel,
the last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when there is no CUDA device or any phase fails.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B, E_BENCH, D = 256, 2304, 16
TOL_KERNEL = 1e-5        # kernel vs plain segment mean (f32, other sum order)
TOL_MODEL = 1e-4         # policy logits / value, card vs CPU
STATE_RTOL, STATE_ATOL = 1e-5, 1e-4   # float state fields, as the CPU tests


def phase(name, t0, **kv):
    print(json.dumps({'phase': name, 'seconds': round(time.time() - t0, 3),
                      **kv}), flush=True)


def cuda_time_ms(fn, reps=20):
    """Median over reps of CUDA-event times of fn(), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port has no CPU '
                         'fallback for this check')

    from urban_tpu_torch import bench
    from urban_tpu_torch.models.policy import MASK_PAD
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                                  broadcast_state,
                                                  make_batch_fns)
    bench.set_precision_flags()
    dev = torch.device('cuda', 0)

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
    segment_ops.load_library()
    phase('build', t0, nvcc_seconds=segment_ops.build_seconds,
          library=os.path.relpath(segment_ops.build_library(),
                                  os.path.dirname(os.path.abspath(__file__))))

    # ---- 3. kernel vs plain at the path's shape -------------------------
    t0 = time.time()
    cfg, spec, init_cpu = bench.setup('hlg', bench.BENCH_CAPS, 'cpu')
    N = spec.num_features
    batch_obs_cpu, batch_step_cpu = make_batch_fns(spec)
    obs0 = batch_obs_cpu(broadcast_state(init_cpu, 1))
    rng = np.random.default_rng(0)
    half = N // 2
    rand_edges = np.concatenate([rng.integers(0, half, (B, E_BENCH, 1)),
                                 rng.integers(half, N, (B, E_BENCH, 1))], -1)
    graphs = {
        'random_bipartite_30pct_masked': (
            torch.as_tensor(rand_edges, dtype=torch.int32),
            torch.as_tensor(rng.random((B, E_BENCH)) >= 0.3)),
        'hlg_initial_observation': (
            obs0[2].expand(B, -1, -1).contiguous(),
            obs0[5].expand(B, -1).contiguous()),
    }
    max_err, ms, plain_ms = 0.0, [], []
    for gname, (edges, mask) in graphs.items():
        h = torch.as_tensor(rng.normal(size=(B, E_BENCH, D)),
                            dtype=torch.float32)
        h = torch.where(mask[..., None], h, 0.0)
        h, edges, mask = h.to(dev), edges.to(dev), mask.to(dev)
        out = segment_ops.segment_mean(h, edges, mask, N)
        again = segment_ops.segment_mean(h, edges, mask, N)
        ref = segment_ops.segment_mean_ref(h, edges, mask, N)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.equal(out, again):
            raise AssertionError(f'{gname}: two launches differ bitwise')
        if not err <= TOL_KERNEL:
            raise AssertionError(f'{gname}: kernel vs plain {err} > '
                                 f'{TOL_KERNEL}')
        max_err = max(max_err, err)
        k_ms = cuda_time_ms(lambda: segment_ops.segment_mean(h, edges, mask, N))
        p_ms = cuda_time_ms(lambda: segment_ops.segment_mean_ref(h, edges,
                                                                 mask, N))
        ms.append(k_ms)
        plain_ms.append(p_ms)
        phase('kernel_vs_plain', t0, graph=gname, shape=[B, E_BENCH, N, D],
              max_abs_err=err, bitwise_repeat=True, kernel_ms=k_ms,
              plain_ms=p_ms)

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

    # ---- 5. the slice: batched HLG rollout ------------------------------
    t0 = time.time()
    bench.run_rollout_bench(num_envs=B, num_steps=2, device=dev)  # warm-up
    segment_ops.launches = 0
    stats = bench.run_rollout_bench(num_envs=B, num_steps=30, device=dev)
    launches = segment_ops.launches
    expect = 30 * model_cpu.num_gcn_layers
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

    phase('total', t_start)
    print(json.dumps({'kernels': [{
        'name': 'segment_mean',
        'route': 'cuda',
        'source': 'urban_tpu_torch/csrc/segment_mean.cu',
        'replaces': 'urban_tpu/ops/pallas/segment_ops.py:108',
        'launches': launches,
        'max_abs_err': max_err,
        'ms': ms[0],
        'plain_ms': plain_ms[0],
    }]}))
    print(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
