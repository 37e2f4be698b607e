"""End-to-end driver on the port: serve a small model through the session
client API over the paged-KV split store, on ``--device``.

Shows sessions with different consistency modes coexisting on one
engine, prefix-cache admission deduplicating a shared prompt prefix, the
zero-copy fork, and the observability plane: ``--trace out.json`` writes
a Chrome trace-event file (open in Perfetto / chrome://tracing) and the
run prints where each stage's wall time went (scheduler / device /
persistence) with session-level stats.

    PYTHONPATH=src python examples/serve_kv_torch.py [--arch qwen2-1.5b]
    PYTHONPATH=src python examples/serve_kv_torch.py --device cpu \\
        --trace serve_trace.json

``--device`` defaults to ``cuda`` and raises without a card.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import PMDevice
from repro_torch.core.modes import Mode
from repro_torch.core.oplog import OpLog
from repro_torch.kernels.common import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.obs import Obs
from repro_torch.serve import ServeClient


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace-event JSON of the run here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    api = build_model(cfg)
    params = init_params(api.init_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    oplog = OpLog(PMDevice(size=16 * 1024 * 1024), base_block=1,
                  num_blocks=64)
    obs = Obs(trace=bool(args.trace))
    client = ServeClient(api, params, max_batch=args.max_batch,
                         max_seq=128, page_tokens=16, oplog=oplog, obs=obs,
                         device=dev)

    # two applications, two consistency modes, ONE engine: the STRICT
    # session's page publishes are oplogged; the POSIX one rides free
    posix = client.open_session()
    strict = client.open_session(mode=Mode.STRICT)

    rng = np.random.default_rng(0)
    shared = list(rng.integers(1, cfg.vocab, 32))   # common prompt prefix
    t0 = time.monotonic()
    for i in range(args.requests):
        sess = strict if i % 4 == 0 else posix
        tail = list(rng.integers(1, cfg.vocab, int(rng.integers(4, 24))))
        sess.submit(shared + tail, max_new_tokens=12)
    done = client.run_until_done()
    dt = time.monotonic() - t0

    toks = sum(len(r.output) for r in done)
    st = client.stats()
    print(f"arch={cfg.name}  device={dev}  requests={len(done)}  "
          f"generated={toks} tokens  wall={dt:.1f}s  "
          f"engine_steps={st['steps']}")
    print(f"paged store: relinked={st['pages_relinked']} pages, "
          f"CoW-copied={st['pages_copied']}, adopted={st['pages_adopted']}, "
          f"pool-util-peak~{st['utilization']:.1%}")
    pc = st.get("prefix_cache", {})
    print(f"prefix cache: hits={pc.get('hits', 0)} "
          f"tokens_saved={pc.get('tokens_saved', 0)} "
          f"(the shared 32-token prefix prefills ONCE, then every later "
          f"request adopts its pages at admission)")

    # streaming generation: Session.generate drives the shared engine and
    # yields tokens as they are sampled (per-request sampling params)
    stream = posix.generate(shared[:16], max_new_tokens=8,
                            temperature=0.7, top_k=40)
    print(f"streamed (T=0.7, top-k 40): {list(stream)}")

    # zero-copy beam fork demo: prefill + a few decode steps, then fork
    # mid-generation (shared prefix pages by refcount, CoW tail)
    engine = client.engine
    r = posix.submit(list(rng.integers(1, cfg.vocab, 16)), max_new_tokens=10)
    for _ in range(4):
        engine.step()
    child = engine.fork(r)
    client.run_until_done()
    print(f"forked request {r.rid}->{child.rid}: parent={r.output} "
          f"child={child.output} (shared prefix pages, "
          f"{engine.controller.pages_copied} CoW copies total)")

    # observability: where did the time go?  (client / scheduler / device
    # / persistence)
    bd = obs.ledger.breakdown()
    for phase, d in bd["phases"].items():
        sh = d["shares"]
        print(f"overhead [{phase}]: scheduler {sh['scheduler']:.1%}  "
              f"device {sh['device']:.1%}  "
              f"persistence {sh['persistence']:.1%}  ({d['steps']} steps)")
    ss = strict.stats()
    print(f"strict session: {ss['submitted']} requests, "
          f"{ss['tokens_out']} tokens, "
          f"oplog appends={client.stats()['obs']['counters'].get('oplog.appends', 0)}")
    if args.trace:
        client.dump_trace(args.trace)
        print(f"trace -> {args.trace} (open in Perfetto or "
              f"chrome://tracing)")


if __name__ == "__main__":
    main()
