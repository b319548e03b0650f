"""The port's started engine under concurrent callers: client threads
submit while reader threads take the engine's host views (the HTTP
front end's pattern), with more threads than cores and a short switch
interval. No JAX here: the tokens are held to a synchronous run."""

import sys
import threading

import numpy as np
import torch

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import exporters
from paddle_tpu_torch.serving import metrics as tsm


def test_started_engine_under_concurrent_clients():
    """More client threads than cores, switching every microsecond,
    submit to a started port engine while others read ``health``,
    ``debug_requests``, ``stats`` and the exposition: every request
    completes with its tokens (those of a synchronous run), the
    outcome counter rises by exactly the requests, no reader raises."""
    torch.manual_seed(0)
    cfg = LlamaConfig.tiny()
    tm = LlamaForCausalLM(cfg, device="cpu")
    rng = np.random.RandomState(91)
    prompts = [rng.randint(1, cfg.vocab_size, int(n))
               for n in rng.randint(3, 30, 12)]
    kw = dict(max_slots=3, max_len=64, block_size=16, prefill_chunk=16,
              max_queue_depth=64)
    ref = tserving.ServingEngine(tm, device="cpu", **kw)
    want = [ref.submit(p, max_new_tokens=4) for p in prompts]
    ref.run_until_idle()
    eng = tserving.ServingEngine(tm, device="cpu", **kw)
    eng.warmup()
    eng.start()
    done0 = tsm.requests_total.labels("completed").value()
    got, errors = [None] * len(prompts), []
    stop = threading.Event()

    def client(i):
        try:
            got[i] = eng.submit(prompts[i], max_new_tokens=4).result(60)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    def reader():
        while not stop.is_set():
            try:
                eng.health()
                eng.debug_requests()
                eng.stats()
                exporters.prometheus_text()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return
            stop.wait(0.001)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    readers = [threading.Thread(target=reader) for _ in range(4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in readers + threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        eng.stop()
    assert not any(t.is_alive() for t in threads + readers)
    assert not errors, errors[:3]
    assert got == [r.output_tokens for r in want]
    assert tsm.requests_total.labels("completed").value() - done0 == \
        len(prompts)
