"""The serving loop: one client, closed loop, each request a batch of
prompts prefilled and then decoded greedily.

Set-up draws the weights on the card in bf16, the type they are served
in, and a pool of prompt batches from the zipf stream, builds the
program's prefill and decode steps (``launch/steps.make_prefill_step``,
``make_decode_step``, ``greedy``) with the KV caches sized to the whole
generation, and serves one request, which compiles and warms every shape.
The window then serves requests back to back, each from a prompt batch
of its own, until ``seconds`` have passed; the next request starts when
the last has finished.

``serve_prompt_tokens_per_s`` is the prompt tokens of every request begun
in the window over the time to the end of its last request.  Once the
window has closed and the program's state is freed, ``check_requests``
of the window's requests, drawn from the seed, go to the reference
(``bench/reference/model.py`` in float32 over each prompt and its served
tokens): the compared number is the widest gap by which a served token's
logit lies below the reference's best at its position.
"""
from __future__ import annotations

import gc
import random
import time

import torch

from bench import flops as FL
from bench import harness, inputs
from bench import trace as TR
from bench.reference import model as RM


def build_params(c, device, seed):
    """The program's serving tensors from the benchmark's weights."""
    from repro_torch.core import flatparam as FP
    from repro_torch.launch import steps

    cfg = harness.port_arch(c)
    groups = steps.model_groups(cfg, 1)
    shapes = FP.serve_param_shapes(groups, 1)
    lvs = RM.leaves(c)
    params = {}
    for idx, lf in enumerate(lvs):
        w = inputs.logical(lf, inputs.draw(lf, idx, seed, device)
                           .to(torch.bfloat16))
        if tuple(w.shape) != shapes[lf.group][lf.name]:
            raise SystemExit(f"{lf.group}/{lf.name}: the program serves "
                             f"{shapes[lf.group][lf.name]}, the reference "
                             f"{tuple(w.shape)}")
        params.setdefault(lf.group, {})[lf.name] = w
    if {g: set(v) for g, v in params.items()} != {
            g: set(v) for g, v in shapes.items()}:
        raise SystemExit("the program's weights are not the reference's")
    return cfg, params


def reference_gaps(c, t, seed, device, served, fp8=False) -> list[float]:
    """Per served token, the reference's best logit less its logit for the
    token, over ``served``: ``[(prompts (B, P), tokens (B, T + 1))]``.
    With ``fp8``, the gap of the token that the fp8 control ranks first
    at each position, instead of the served one."""
    RM.no_tf32()
    lvs = RM.leaves(c)
    W = {k: w.to(torch.bfloat16).float()
         for k, w in inputs.weights(lvs, seed, device).items()}
    ref = RM.Decoder(c)
    ctl = RM.Decoder(c, fp8=True) if fp8 else None
    n = t["decode_steps"] + 1
    gaps = []
    for prompts, toks in served:
        for r in range(prompts.shape[0]):
            seq = torch.cat([prompts[r], toks[r, :-1]])[None]
            lg = ref.last_logits(W, seq, n)[0]
            pick = (ctl.last_logits(W, seq, n)[0].argmax(-1) if fp8
                    else toks[r])
            best = lg.max(-1).values
            gaps += (best - lg.gather(-1, pick[:, None])[:, 0]).tolist()
    del W
    gc.collect()
    return gaps


def run(c, seed, seconds, trace, device, t0, fault=None) -> dict:
    from repro_torch.core.flatparam import MeshTopo
    from repro_torch.launch import mesh, steps

    cfg_c, t = c["config"], c["traffic"]
    cuda = device.type == "cuda"
    B, P, T = t["batch"], t["prompt_len"], t["decode_steps"]
    with mesh.dp_group(device):
        data, model = mesh.mesh_groups(1)
        topo = MeshTopo.from_group(data, model=model)
        harness.stage(t0, "process group up")
        cfg, params = build_params(cfg_c, device, seed)
        harness.stage(t0, "weights drawn")
        n_pool = 1 + t["trace_requests"] + int(
            t["pool_per_second"] * max(seconds, 1)) + 1
        prompts = inputs.tokens(cfg_c["vocab"], t["n_clusters"],
                                (n_pool, B, P), seed, device)
        prefill = steps.make_prefill_step(
            cfg, topo, device, batch=B, window=steps.serve_window(cfg, P, T))
        decode = steps.make_decode_step(cfg, topo, device)

        def request(i):
            t_a = time.perf_counter()
            logits, state = prefill(params, {"tokens": prompts[i % n_pool]})
            tok = steps.greedy(logits, topo)
            TR.sync(device)
            t_b = time.perf_counter()
            outs = [tok]
            for j in range(T):
                if fault == "token" and j == T // 2:
                    # a token altered where it is produced
                    tok = tok.clone()
                    tok[0] = (tok[0] + 1) % cfg_c["vocab"]
                    outs[-1] = tok
                tok, logits, state = decode(params, state, tok)
                outs.append(tok)
            toks = torch.cat(outs, 1)
            TR.sync(device)
            return toks, t_b - t_a, time.perf_counter() - t_b

        request(0)
        TR.sync(device)
        harness.stage(t0, "warm-up request served")
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t_start = time.perf_counter()
        setup_s = t_start - t0
        done, pre_s, dec_s = [], [], []
        i = 1
        while time.perf_counter() - t_start < seconds:
            toks, a, b = request(i)
            done.append((i, toks))
            pre_s.append(a)
            dec_s.append(b)
            i += 1
        window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        summ, trace_s = None, 0.0
        if trace:
            prof = TR.profiler(device)
            with prof:
                t_tr = time.perf_counter()
                for _ in range(t["trace_requests"]):
                    request(i)
                    i += 1
                trace_s = time.perf_counter() - t_tr
            summ = TR.summary(prof)
        mem_peak = max(setup_peak, peak,
                       torch.cuda.max_memory_allocated(device) if cuda else 0)
        del params, prefill, decode
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    pick = random.Random(seed).sample(done, min(t["check_requests"],
                                                len(done)))
    served = [(prompts[k % n_pool], toks) for k, toks in pick]
    harness.stage(t0, f"window {len(done)} requests in {window_s:.3f} s")
    gaps = reference_gaps(cfg_c, t, seed, device, served)
    harness.stage(t0, "reference done")
    ctx = {"kind": "serve", "config": cfg_c, "traffic": t,
           "prefill_flops": FL.prefill_flops(cfg_c, P, B),
           "prefill_s": pre_s, "decode_s": dec_s, "decode_steps": T,
           "trace": summ, "trace_units": t["trace_requests"],
           "trace_window_s": trace_s,
           "peaks": harness.load_json(harness.BENCH, "peaks.json")}
    return {"e2e": {"serve_prompt_tokens_per_s": len(done) * B * P / window_s,
                    "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
            "ctx": ctx,
            "checks": {"token_gap": max(gaps) if gaps else float("inf")},
            "attempted": len(done) + 1 + (t["trace_requests"] if trace
                                          else 0),
            "failed": 0, "memory_peak_bytes": mem_peak,
            "device_kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
            "served": served}
