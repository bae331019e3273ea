"""Serving driver: continuous batching with chunked prefill on the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --requests 6 --max-new 8 --prefill-chunk 16 --device cpu

The flags and defaults are the reference's (``repro.launch.serve``: a
reduced config on the 8-rank smoke mesh), plus ``--device``: the card
unless ``--device cpu`` is passed.  Weights are random, drawn from
``--seed``.  Passing any of --ttft-deadline-s / --total-deadline-s /
--rate-per-s arms the SLO layer; with deadlines active, late requests are
shed, so the driver reports done + shed == submitted.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import configs
from ..core.context import DiompContext, resolve_device
from ..launch.mesh import make_smoke_mesh
from ..models import api as model_api
from ..models import schema as sch
from ..models.config import ParallelCtx
from ..serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=configs.all_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per prefill device call "
                         "(1 = token-by-token baseline)")
    ap.add_argument("--page-tokens", type=int, default=64,
                    help="KV tokens per PGAS page")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples (with --top-k)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--high-watermark", type=float, default=0.92,
                    help="KV pressure above which the engine preempts")
    ap.add_argument("--ttft-deadline-s", type=float, default=None,
                    help="shed requests whose first token would miss this")
    ap.add_argument("--total-deadline-s", type=float, default=None,
                    help="cancel requests that cannot finish by this")
    ap.add_argument("--rate-per-s", type=float, default=None,
                    help="token-bucket admission rate limit")
    ap.add_argument("--burst", type=float, default=8.0,
                    help="token-bucket depth for --rate-per-s")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="hard queue bound: submissions beyond it reject")
    ap.add_argument("--queue-high", type=int, default=16,
                    help="backpressure/degrade watermark")
    ap.add_argument("--queue-low", type=int, default=4,
                    help="hysteresis watermark clearing backpressure")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (the card by default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)

    slo = None
    if (args.ttft_deadline_s is not None or args.total_deadline_s is not None
            or args.rate_per_s is not None):
        from ..serve.slo import SLOPolicy, TierPolicy
        slo = SLOPolicy(
            default_tier=TierPolicy(ttft_deadline_s=args.ttft_deadline_s,
                                    total_deadline_s=args.total_deadline_s,
                                    rate_per_s=args.rate_per_s,
                                    burst=args.burst),
            max_queue=args.max_queue, queue_high=args.queue_high,
            queue_low=args.queue_low)

    cfg = configs.get_reduced(args.arch)
    if not model_api.has_decode(cfg):
        ap.error(f"{args.arch} is an encoder ({cfg.family!r} family): it "
                 f"has no decode step to serve")
    device = resolve_device(args.device)
    mesh = make_smoke_mesh(8)
    ctx = ParallelCtx.from_mesh(mesh, remat=False, inference=True)
    dctx = DiompContext(mesh=mesh, device=device, segment_bytes=1 << 26,
                        allocator="buddy")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = sch.init_params(cfg, mesh, gen, device=device)

    eng = ServeEngine(cfg, mesh, ctx, params, slots=args.slots, max_len=96,
                      prefill_chunk=args.prefill_chunk,
                      page_tokens=args.page_tokens,
                      temperature=args.temperature, top_k=args.top_k,
                      high_watermark=args.high_watermark, slo=slo,
                      context=dctx)
    rng = np.random.RandomState(args.seed)
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size,
                                   size=rng.randint(2, args.max_prompt)),
                       max_new=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    shed = sum(r.shed_reason is not None for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in "
          f"{eng.steps} engine steps / {eng.device_calls} device calls "
          f"({dt:.1f}s incl. kernel builds) on {device}")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i} prompt[{len(r.prompt)}] -> {r.out} "
              f"(prefill_steps={r.prefill_steps})")
    print("kv stats:", eng.kv_stats)
    print("latency:", json.dumps(eng.latency_stats(), default=float))
    if slo is not None:
        print(f"slo: {shed} shed, {len(eng.slo_log)} decision-log entries")
        assert done + shed == len(reqs)
    else:
        assert done == len(reqs)
    print("serve driver done")


if __name__ == "__main__":
    main()
