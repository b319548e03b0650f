"""The kernel modules' launch and dispatch counters under concurrent
engines: two replicas in one process launch from two loop threads, so a
count that a thread switch can split (read, switch, store) would make
the card's exact launch checks fail at random. Here four threads hammer
the counting paths the CPU runs (the dispatch decisions of the plain
paths, and the launch counter itself) with a switch interval of a
microsecond, and every count must come out exact."""

import sys
import threading

import pytest
import torch

from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.kernels import quant_matmul as qm

THREADS, ROUNDS = 4, 3000


@pytest.fixture
def fast_switches():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    da.reset_counters()
    qm.reset_counters()
    yield
    sys.setswitchinterval(old)
    da.reset_counters()
    qm.reset_counters()


def _hammer(work, rounds=ROUNDS):
    errors = []

    def run():
        try:
            with torch.no_grad():
                for _ in range(rounds):
                    work()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_decode_dispatch_counts_are_exact(fast_switches):
    def work():
        da.decode_dispatch("llama", q_len=1, has_mask=False,
                           dtype=torch.float32)
        da.paged_decode_dispatch("llama", q_len=256, has_mask=False,
                                 dtype=torch.bfloat16)
        da.paged_decode_dispatch("llama", q_len=1, has_mask=False,
                                 dtype=torch.float16, quantized=True)
        da.decode_dispatch("llama", q_len=1, has_mask=True,
                           dtype=torch.float32)

    _hammer(work)
    n = THREADS * ROUNDS
    assert da.DISPATCH_HITS == {"llama": n, "llama_paged": n}
    assert sum(da.DISPATCH_FALLBACKS.values()) == 2 * n
    assert da.DISPATCH_FALLBACKS["paged_quant_dtype"] == n


def test_launch_counts_are_exact(fast_switches):
    name = "paged_flash_decode_attention"

    def work():
        da._count(da.LAUNCHES, name)
        da._count(da.BODY_LAUNCHES, f"{name}/qrows")
        qm._count(qm.LAUNCHES, "quant_matmul")
        qm.quant_matmul_dispatch(dtype=torch.bfloat16, fmt="int8")

    _hammer(work)
    n = THREADS * ROUNDS
    assert da.LAUNCHES[name] == n
    assert da.BODY_LAUNCHES[f"{name}/qrows"] == n
    assert qm.LAUNCHES["quant_matmul"] == n
    assert qm.DISPATCH_HITS["int8"] == n
    da.reset_counters()
    qm.reset_counters()
    assert da.LAUNCHES[name] == 0 and not da.BODY_LAUNCHES
    assert qm.LAUNCHES["quant_matmul"] == 0 and not qm.DISPATCH_HITS


def test_plain_paths_count_from_threads(fast_switches):
    """The wrappers on CPU tensors from four threads: each call takes the
    plain version (nothing is launched) and the dispatch counts are
    exact."""
    torch.manual_seed(0)
    x = torch.randn(2, 16)
    qweight = torch.randint(-127, 127, (8, 16), dtype=torch.int8)  # [N, K]
    scale = torch.rand(8) + 0.5
    want = qm.quant_matmul(x, qweight, scale)

    def work():
        if qm.quant_matmul_dispatch(dtype=x.dtype, fmt="int8"):
            torch.testing.assert_close(qm.quant_matmul(x, qweight, scale),
                                       want, rtol=0, atol=0)

    _hammer(work, rounds=300)
    assert qm.DISPATCH_HITS["int8"] == THREADS * 300
    assert qm.LAUNCHES["quant_matmul"] == 0
