"""The port's serving engine and client against the JAX package's, at fp32
on qwen2-1.5b SMOKE with the JAX package's weights: identical greedy token
streams in the scenarios of tests/test_chunked_prefill.py, identical
STRICT oplog commits and crash replay, the session client with POSIX and
STRICT sessions and a text prompt, the device default, and the port's
import isolation."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import PMDevice as JaxPMDevice
from repro.core.kvcache import replay_kv_commits as jax_replay
from repro.core.modes import Mode as JaxMode
from repro.core.oplog import OpLog as JaxOpLog
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.serve import ServeClient as JaxServeClient
from repro.serve import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import OP_KV_COMMIT, Mode, OpLog, PMDevice
from repro_torch.core.kvcache import replay_kv_commits
from repro_torch.models import build_model
from repro_torch.serve import ServeClient, ServingEngine

PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def pair():
    """(jax api, jax params, port api, port params) at fp32."""
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b", smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               dtype=torch.float32)
    japi = jax_build_model(jcfg)
    jparams = jax_init_params(japi.init_specs(), jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return japi, jparams, build_model(tcfg), tparams


def engines(pair, **kw):
    japi, jparams, tapi, tparams = pair
    jkw = dict(kw)
    if "mode" in jkw:
        jkw["mode"] = JaxMode(int(jkw["mode"]))
    return (JaxEngine(japi, jparams, prefix_cache=None, **jkw),
            ServingEngine(tapi, tparams, device="cpu", **kw))


def oplogs():
    jdev = JaxPMDevice(size=4 * 1024 * 1024)
    tdev = PMDevice(size=4 * 1024 * 1024)
    return (jdev, JaxOpLog(jdev, base_block=1, num_blocks=16),
            tdev, OpLog(tdev, base_block=1, num_blocks=16))


def test_engine_chunked_equals_token_at_a_time_and_reference(pair):
    outs = {}
    for C in (1, 8):
        je, te = engines(pair, max_batch=2, max_seq=64, page_tokens=8,
                         chunk_tokens=C)
        jr, tr = je.submit(PROMPT, max_new_tokens=5), \
            te.submit(PROMPT, max_new_tokens=5)
        je.run_until_done()
        te.run_until_done()
        assert tr.output == jr.output and tr.done and not tr.truncated
        assert te.controller.pages_relinked == je.controller.pages_relinked
        assert te.steps == je.steps
        outs[C] = (tr.output, te.steps)
    assert outs[1][0] == outs[8][0]
    assert outs[8][1] < outs[1][1] - len(PROMPT) // 2


def test_one_publish_per_full_chunk(pair):
    je, te = engines(pair, max_batch=1, max_seq=128, page_tokens=16)
    prompt = list(range(1, 65))                 # 64 tokens = 4 full chunks
    jr, tr = je.submit(prompt, max_new_tokens=1), \
        te.submit(prompt, max_new_tokens=1)
    while tr.in_prefill:
        te.step()
    while jr.in_prefill:
        je.step()
    assert te.steps == je.steps == 4
    assert te.controller.pages_relinked == je.controller.pages_relinked == 4
    assert tr.output == jr.output


def test_mixed_prefill_decode_batch_matches_solo_and_reference(pair):
    je, te = engines(pair, max_batch=2, max_seq=64, page_tokens=8)
    solo = te.submit(PROMPT[:5], max_new_tokens=6)
    te.run_until_done()
    outs = []
    for eng in engines(pair, max_batch=2, max_seq=64, page_tokens=8):
        r2 = eng.submit(PROMPT[:5], max_new_tokens=6)
        eng.step()                              # r2 prefill chunk alone
        r3 = eng.submit(PROMPT, max_new_tokens=4)
        eng.run_until_done()
        outs.append((r2.output, r3.output))
    assert outs[0] == outs[1]
    assert outs[1][0] == solo.output


def test_strict_logs_one_commit_per_page_like_reference(pair):
    jdev, jlog, tdev, tlog = oplogs()
    je = JaxEngine(pair[0], pair[1], prefix_cache=None, max_batch=1,
                   max_seq=64, page_tokens=8, mode=JaxMode.STRICT, oplog=jlog)
    te = ServingEngine(pair[2], pair[3], device="cpu", max_batch=1,
                       max_seq=64, page_tokens=8, mode=Mode.STRICT,
                       oplog=tlog)
    for eng in (je, te):
        req = eng.submit(list(range(1, 25)), max_new_tokens=1)  # 3 pages
        while req.in_prefill:
            eng.step()
    jent = [e for e in jlog.scan() if e.op == OP_KV_COMMIT]
    tent = [e for e in tlog.scan() if e.op == OP_KV_COMMIT]
    assert [e.offset for e in tent] == [0, 1, 2]
    assert [(e.inode, e.offset, e.staging_addr, e.aux1) for e in tent] == \
        [(e.inode, e.offset, e.staging_addr, e.aux1) for e in jent]


def test_strict_crash_mid_prefill_replays_to_reference_pages(pair):
    jdev, jlog, tdev, tlog = oplogs()
    je = JaxEngine(pair[0], pair[1], prefix_cache=None, max_batch=1,
                   max_seq=128, page_tokens=8, mode=JaxMode.STRICT, oplog=jlog)
    te = ServingEngine(pair[2], pair[3], device="cpu", max_batch=1,
                       max_seq=128, page_tokens=8, mode=Mode.STRICT,
                       oplog=tlog)
    reqs = []
    for eng in (je, te):
        req = eng.submit(list(range(1, 45)), max_new_tokens=4)  # 44 tokens
        for _ in range(5):                      # 40 tokens: "crash" here
            eng.step()
        reqs.append(req)
    expected = te.controller.committed_extents(reqs[1].seq_id)
    assert len(expected) == 5 and reqs[1].in_prefill
    entries = OpLog(tdev, base_block=1, num_blocks=16, fresh=False).scan()
    state = replay_kv_commits(entries)
    assert state == replay_kv_commits(list(entries) + list(entries))
    assert state[reqs[1].seq_id] == expected
    jstate = jax_replay(JaxOpLog(jdev, base_block=1, num_blocks=16,
                                 fresh=False).scan())
    assert state == jstate


def test_client_sessions_stream_reference_tokens(pair):
    """One POSIX and one STRICT session on one client, one of them with a
    text prompt: the same streams as the reference client, and only the
    STRICT session's pages in the oplog."""
    japi, jparams, tapi, tparams = pair
    jdev, jlog, tdev, tlog = oplogs()
    jc = JaxServeClient(japi, jparams, max_batch=2, max_seq=64,
                        page_tokens=8, oplog=jlog, prefix_cache=False)
    tc = ServeClient(tapi, tparams, max_batch=2, max_seq=64, page_tokens=8,
                     oplog=tlog, device="cpu")
    results = []
    for client, mode in ((jc, JaxMode), (tc, Mode)):
        strict = client.open_session(mode=mode.STRICT)
        posix = client.open_session(mode=mode.POSIX)
        rs = strict.submit(list(range(1, 25)), max_new_tokens=6)
        streamed = list(posix.generate("paged kv, split", max_new_tokens=6))
        client.run_until_done()
        results.append((rs.output, streamed, posix.requests[-1].output))
        posix.close()
        with pytest.raises(RuntimeError):
            posix.submit([1, 2])
    assert results[0] == results[1]
    assert results[1][1] == results[1][2] and len(results[1][1]) == 6
    committed = [e for e in tlog.scan() if e.op == OP_KV_COMMIT]
    assert committed and {e.mode for e in committed} == {int(Mode.STRICT)}
    assert len(committed) == len([e for e in jlog.scan()
                                  if e.op == OP_KV_COMMIT])


def test_abandoned_stream_cancels_and_frees_pages(pair):
    tc = ServeClient(pair[2], pair[3], max_batch=2, max_seq=64,
                     page_tokens=8, device="cpu")
    gen = tc.open_session().generate(PROMPT, max_new_tokens=8)
    next(gen)
    gen.close()
    ctrl = tc.engine.controller
    assert not tc.engine.active and tc.engine.cancels == 1
    # the prompt's full page stays pinned by the prefix cache (on by
    # default, as in the reference); every other page is back
    assert ctrl.num_free_pages == \
        ctrl.geom.num_pages - 1 - tc.engine.prefix_cache.pinned_pages
    tc.engine.prefix_cache.clear()
    assert ctrl.num_free_pages == ctrl.geom.num_pages - 1


def test_submit_rejects_infeasible_prompts_like_reference(pair):
    je, te = engines(pair, max_batch=2, max_seq=64, page_tokens=16)
    for eng in (je, te):
        with pytest.raises(ValueError):
            eng.submit([])
        with pytest.raises(ValueError):
            eng.submit(list(range(1, 101)))      # 100 > 63 stageable tokens
    jr, tr = je.submit(list(range(1, 60)), max_new_tokens=2), \
        te.submit(list(range(1, 60)), max_new_tokens=2)
    je.run_until_done()
    te.run_until_done()
    assert tr.done and tr.output == jr.output


def test_client_without_device_defaults_to_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeClient(pair[2], pair[3])
    with pytest.raises(RuntimeError, match="cuda"):
        pair[2].init_caches(1, 16, 8)


def test_client_builds_a_prefix_cache_by_default_like_reference(pair):
    """The reference's ``ServeClient`` turns the prefix cache on unless
    told otherwise; so does the port's, and the engine alone leaves it
    off, in both."""
    japi, jparams, tapi, tparams = pair
    kw = dict(max_batch=1, max_seq=32, page_tokens=8)
    jc, tc = (JaxServeClient(japi, jparams, **kw),
              ServeClient(tapi, tparams, device="cpu", **kw))
    assert jc.engine.prefix_cache is not None
    assert tc.engine.prefix_cache is not None
    assert ServeClient(tapi, tparams, device="cpu", prefix_cache=False,
                       **kw).engine.prefix_cache is None
    assert ServingEngine(tapi, tparams, device="cpu",
                         **kw).prefix_cache is None


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import sys, torch
        from repro_torch.configs import get_config
        from repro_torch.models import build_model, init_params
        from repro_torch.serve import ServeClient
        import repro_torch.core.tier, repro_torch.obs
        import repro_torch.serve.prefix_cache
        cfg = get_config("qwen2-1.5b", smoke=True)
        api = build_model(cfg)
        g = torch.Generator(device="cpu").manual_seed(0)
        params = init_params(api.init_specs(), g, device="cpu")
        client = ServeClient(api, params, max_batch=1, max_seq=32,
                             page_tokens=8, device="cpu")
        out = list(client.open_session().generate([3, 4, 5], 3))
        assert len(out) == 3, out
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
