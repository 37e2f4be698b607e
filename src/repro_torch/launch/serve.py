"""Serving driver of the port: the session client API over continuous
batching (port of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 12
  python -m repro_torch.launch.serve --rate 8 --shared-prefix 0.5  # open loop
  python -m repro_torch.launch.serve --engines 2 --spares 1 --rate 8 \
      --kill-at 0.5                                      # cluster + fault
  python -m repro_torch.launch.serve --smoke --device cpu     # on the CPU

Each run opens one session per consistency mode named in ``--modes``
(sessions coexist on ONE engine; only STRICT sessions pay oplog
publishes) and spreads the requests round-robin across them.  With
``--rate`` the requests arrive open-loop (Poisson) through
serve.arrival.OpenLoopDriver and the summary adds TTFT/TPOT percentiles.

The model runs at its published widths on ``--device`` (default ``cuda``;
raises without a card) from weights drawn with a ``torch.Generator``
seeded by ``--seed``; ``--smoke`` takes the architecture's SMOKE config,
which the reference driver always runs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import PMDevice
from ..core.modes import Mode
from ..core.oplog import OpLog
from ..kernels.common import resolve_device
from ..models import build_model
from ..models.spec import init_params
from ..obs import Obs
from ..serve import ArrivalSpec, OpenLoopDriver, ServeClient, SpecConfig
from ..serve.arrival import poisson_schedule


def make_prompts(rng, vocab: int, n: int, shared_frac: float) -> list:
    """Random prompts; ``shared_frac`` of each prompt (page-rounded by the
    engine) is a common prefix — the prefix-cache's workload."""
    shared = list(rng.integers(1, vocab, 32))
    out = []
    for _ in range(n):
        plen = int(rng.integers(8, 32))
        keep = int(len(shared) * shared_frac)
        out.append(shared[:keep] + list(rng.integers(1, vocab, plen)))
    return out


def _print_open_loop(result, args) -> None:
    if result is None:
        return
    pct = result.percentiles()
    ttft, lat = pct["ttft"], pct["latency"]
    if ttft:
        tail = (f" latency p99={lat['p99']*1e3:.0f}ms" if lat else
                " (no request completed: latency n/a)")
        print(f"[serve] open-loop @{args.rate}rps: "
              f"TTFT p50={ttft['p50']*1e3:.0f}ms "
              f"p99={ttft['p99']*1e3:.0f}ms{tail}")


def _print_stragglers(engine) -> None:
    stalled = [r for r in list(engine.waiting) + list(engine.active.values())
               if r.stalled]
    if stalled:
        print(f"[serve] WARNING: {len(stalled)} requests stalled (timeout)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="prefill chunk size (0 = page_tokens: one page "
                         "publish per chunk; 1 = token-at-a-time baseline)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--modes", default="posix",
                    help="comma list of session modes (posix,sync,strict); "
                         "requests round-robin across the sessions")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft up to K tokens per "
                         "decode step via n-gram prompt lookup (0 = off; "
                         "greedy sessions only)")
    ap.add_argument("--shared-prefix", type=float, default=0.0,
                    help="fraction of each prompt drawn from a common "
                         "prefix (exercises prefix-cache admission)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--host-cache-pages", type=int, default=0,
                    help="host-memory cold tier below the device pool: "
                         "evicted prefix-cache chains spill D2H and "
                         "re-admit via async promote (0 = off)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="cap the device pool's allocatable pages "
                         "(pressure experiments; 0 = full geometry)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s "
                         "(0 = submit everything up front)")
    ap.add_argument("--engines", type=int, default=1,
                    help="shard engines behind the client (> 1 = cluster "
                         "mode with prefix-affinity routing, DESIGN.md "
                         "§12)")
    ap.add_argument("--spares", type=int, default=0,
                    help="idle spare engines the fault ladder can steal "
                         "dead/straggling engines' sessions onto")
    ap.add_argument("--kill-at", type=float, default=0.0,
                    help="with --rate and cluster mode: kill the busiest "
                         "shard engine at this many seconds into the "
                         "open-loop run (0 = no fault)")
    ap.add_argument("--trace", default="",
                    help="obs-instrument the run and write a Chrome "
                         "trace-event JSON here (view in Perfetto)")
    ap.add_argument("--stats", action="store_true",
                    help="obs-instrument the run and print the overhead "
                         "breakdown + windowed throughput")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's SMOKE config (default: its "
                         "published widths)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    api = build_model(cfg)
    params = init_params(
        api.init_specs(),
        torch.Generator(device=device).manual_seed(args.seed), device=device)
    modes = [Mode[m.strip().upper()] for m in args.modes.split(",")]
    cluster_mode = args.engines > 1 or args.spares > 0
    oplog = make_oplog = None
    if any(m.logs_ops for m in modes):
        # cluster mode: one log per engine VOLUME (each engine is its own
        # durability domain, DESIGN.md §12), via the factory
        def make_oplog():
            return OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                         num_blocks=64)
        if not cluster_mode:
            oplog = make_oplog()
            make_oplog = None
    obs = Obs(trace=bool(args.trace)) if (args.trace or args.stats) else None
    client = ServeClient(api, params, max_batch=args.max_batch,
                         max_seq=args.max_seq, page_tokens=args.page_tokens,
                         chunk_tokens=args.chunk_tokens or None,
                         oplog=oplog, prefix_cache=not args.no_prefix_cache,
                         host_cache_pages=args.host_cache_pages,
                         pool_pages=args.pool_pages or None,
                         n_engines=args.engines, n_spares=args.spares,
                         make_oplog=make_oplog,
                         obs=obs, device=device)
    spec = SpecConfig(k=args.spec_k) if args.spec_k > 0 else None
    sessions = [client.open_session(mode=m, temperature=args.temperature,
                                    top_k=args.top_k, spec=spec)
                for m in modes]
    rng = np.random.default_rng(args.seed)
    prompts = make_prompts(rng, cfg.vocab, args.requests, args.shared_prefix)

    t0 = time.monotonic()
    faults = []
    if cluster_mode and args.kill_at > 0 and args.rate > 0:
        cluster = client.engine

        def kill_busiest():
            victim = max(
                (e for e in range(args.engines)
                 if e not in cluster._killed),
                key=lambda e: (len(cluster.engines[e].active),
                               len(cluster.engines[e].waiting)))
            print(f"[serve] FAULT: killing engine {victim}")
            cluster.kill(victim)

        faults = [(args.kill_at, kill_busiest)]
    if args.rate > 0:
        sched = poisson_schedule(len(prompts), args.rate, seed=args.seed)
        # ONE open-loop driver; requests round-robin across the mode
        # sessions via per-spec session routing (mixed-mode traffic)
        workload = [ArrivalSpec(t, p, args.max_new_tokens,
                                session=sessions[j % len(sessions)])
                    for j, (t, p) in enumerate(zip(sched, prompts))]
        result = OpenLoopDriver(client, session=sessions[0]).run(
            workload, faults=faults)
        done = list(client.engine.finished)
    else:
        for i, prompt in enumerate(prompts):
            sessions[i % len(sessions)].submit(
                prompt, max_new_tokens=args.max_new_tokens)
        done = client.run_until_done()
        result = None
    dt = time.monotonic() - t0

    engine = client.engine
    total_tokens = sum(len(r.output) for r in done)
    if cluster_mode:
        st = client.stats()["cluster"]
        print(f"[serve] {len(done)} requests, {total_tokens} tokens in "
              f"{dt:.2f}s ({st['ticks']} cluster ticks, "
              f"{args.engines} engines + {args.spares} spares, "
              f"sessions={','.join(m.name for m in modes)})")
        rt = st["router"]
        print(f"[serve] router: {rt['routed_home']} home / "
              f"{rt['spills']} spilled; migrations={st['migrations']} "
              f"(migrated={st['sessions_migrated']} "
              f"requeued={st['sessions_requeued']}), "
              f"fault={st['fault']}")
        _print_open_loop(result, args)
        _print_stragglers(engine)
        return
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({engine.steps} engine steps, chunk={engine.chunk}, "
          f"sessions={','.join(m.name for m in modes)})")
    st = client.stats()
    print(f"[serve] pages relinked={st['pages_relinked']} "
          f"CoW-copied={st['pages_copied']} adopted={st['pages_adopted']} "
          f"pool utilization={st['utilization']:.2%}")
    if "prefix_cache" in st:
        pc = st["prefix_cache"]
        print(f"[serve] prefix cache: hits={pc['hits']} "
              f"misses={pc['misses']} tokens_saved={pc['tokens_saved']}")
    if engine.tier is not None:
        t = engine.tier
        lag = (engine.promote_lag_ns / engine.promote_events / 1e6
               if engine.promote_events else 0.0)
        print(f"[serve] host tier: demoted={t.pages_demoted} "
              f"promoted={t.pages_promoted} resident={t.host_pages}"
              f"/{t.capacity_pages} drops={t.host_drops} "
              f"promote_lag p50-ish={lag:.1f}ms "
              f"({engine.promote_events} staged promotions)")
    _print_open_loop(result, args)
    if engine.spec_steps:
        drafted = engine.spec_drafted_tokens
        acc = engine.spec_accepted_tokens
        print(f"[serve] speculation: {engine.spec_steps} spec steps, "
              f"{drafted} drafted, {acc} accepted "
              f"({acc / drafted:.0%} accept rate), "
              f"{engine.spec_rollbacks} rollbacks")
    _print_stragglers(engine)
    if obs is not None:
        bd = obs.ledger.breakdown()
        for phase, d in bd["phases"].items():
            sh = d["shares"]
            print(f"[serve] overhead {phase}: sched {sh['scheduler']:.1%} "
                  f"device {sh['device']:.1%} "
                  f"persist {sh['persistence']:.1%} ({d['steps']} steps)")
        windows = obs.profiler.windows()
        if windows:
            peak = max(w.tok_s for w in windows)
            print(f"[serve] {len(windows)} profiler windows, "
                  f"peak {peak:.0f} tok/s")
        if args.trace:
            client.dump_trace(args.trace)
            print(f"[serve] trace -> {args.trace} "
                  f"({len(obs.tracer)} events)")
    for r in done[:3]:
        print(f"  req {r.rid} [{r.mode.name}]: prompt[{len(r.prompt)}] "
              f"prefix_hit={r.prefix_tokens} -> {r.output}")


if __name__ == "__main__":
    main()
