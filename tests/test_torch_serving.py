"""Port: spmm_tpu_torch.serving and cli.serve, held to what
tests/test_serving.py and tests/test_serve_cli.py pin for the JAX package —
request coalescing that callers cannot see, deadline flushes, failures on
every future of a batch, the offline results through the service and over
HTTP, partial conditioning, 400s on malformed input and /healthz, for
POST /pv2smiles and POST /smiles2pv.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spmm_tpu_torch.chem.normalize import PropertyStats
from spmm_tpu_torch.cli.serve import make_server
from spmm_tpu_torch.inference.pv2smiles import generate_batched
from spmm_tpu_torch.serving import (
    BatchingService, Pv2SmilesService, Smiles2PvService)
from spmm_tpu_torch.tokenizer import SmilesTokenizer

from torch_parity import CPU, jax_tree, port_model


def test_results_in_order_and_batched():
    seen_sizes = []

    def batch_fn(items, n):
        seen_sizes.append(len(items))
        return [x * 2 for x in items]

    with BatchingService(batch_fn, batch_size=4, max_wait_ms=200.0) as svc:
        out = svc.map(list(range(10)))
    assert out == [x * 2 for x in range(10)]
    assert all(s == 4 for s in seen_sizes)
    assert svc.stats["requests"] == 10
    assert 3 <= svc.stats["batches"] <= 10


def test_timeout_flushes_short_batch():
    svc = BatchingService(lambda items, n: list(items), batch_size=64,
                          max_wait_ms=30.0)
    try:
        t0 = time.monotonic()
        assert svc.submit("lone").result(timeout=5.0) == "lone"
        assert time.monotonic() - t0 < 2.0
        assert svc.stats["padded_slots"] >= 63
    finally:
        svc.close()


def test_exception_propagates_to_all_futures():
    def batch_fn(items, n):
        raise RuntimeError("device on fire")

    svc = BatchingService(batch_fn, batch_size=2, max_wait_ms=10.0)
    try:
        futs = [svc.submit(i) for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device on fire"):
                f.result(timeout=5.0)
    finally:
        svc.close()


def test_close_drains_then_rejects():
    def batch_fn(items, n):
        time.sleep(0.01)
        return list(items)

    svc = BatchingService(batch_fn, batch_size=4, max_wait_ms=5.0)
    futs = [svc.submit(i) for i in range(9)]
    svc.close()
    assert [f.result(timeout=5.0) for f in futs] == list(range(9))
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(1)


def test_concurrent_submitters():
    results = {}
    with BatchingService(lambda items, n: [x + 1 for x in items],
                         batch_size=8, max_wait_ms=20.0) as svc:
        def client(base):
            results[base] = [svc.submit(base + i).result(timeout=10.0)
                             for i in range(5)]

        threads = [threading.Thread(target=client, args=(b,))
                   for b in (0, 100, 200)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30.0)
            assert not th.is_alive()
    for base in (0, 100, 200):
        assert results[base] == [base + i + 1 for i in range(5)]


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    return port_model(jax_tree(11, sep_bias=0.5)), SmilesTokenizer()


def test_pv2smiles_service_matches_offline(tiny):
    model, tok = tiny
    pvs = np.random.default_rng(0).normal(size=(8, 53)).astype(np.float32)
    want = generate_batched(model, tok, pvs, k=2, seed=0, device_batch=8,
                            device=CPU)
    with Pv2SmilesService(model, tok, k=2, batch_size=8, max_wait_ms=50.0,
                          device=CPU) as svc:
        got = svc.map(list(pvs))
        # a padded 5-batch reproduces the full-batch results
        ragged = svc.map(list(pvs[:5]))
    assert got == want
    assert ragged == want[:5]
    assert all(isinstance(s, str) for s in got)


def test_pv2smiles_service_mask_conditioning(tiny):
    """An all-zero mask equals a bare pv; masked slots' values are inert,
    NaN included; masked and unmasked requests share a batch."""
    model, tok = tiny
    pvs = np.random.default_rng(3).normal(size=(4, 53)).astype(np.float32)
    zero = np.zeros(53, np.float32)
    mask = np.zeros(53, np.float32)
    mask[20:] = 1.0
    scrambled = pvs.copy()
    scrambled[:, 20:] = 1e6
    scrambled[:, 20] = np.nan
    with Pv2SmilesService(model, tok, k=2, batch_size=4, max_wait_ms=50.0,
                          device=CPU) as svc:
        plain = svc.map(list(pvs))
        tupled = svc.map([(pv, zero) for pv in pvs])
        masked = svc.map([(pv, mask) for pv in pvs])
        masked_scrambled = svc.map([(pv, mask) for pv in scrambled])
        mixed = svc.map([pvs[0], (pvs[1], mask), pvs[2], (pvs[3], mask)])
    assert tupled == plain
    assert masked == masked_scrambled
    assert all(isinstance(s, str) for s in masked)
    assert mixed == [plain[0], masked[1], plain[2], masked[3]]


def test_pv2smiles_service_stochastic_is_reproducible(tiny):
    model, tok = tiny
    pvs = np.random.default_rng(2).normal(size=(4, 53)).astype(np.float32)

    def run():
        with Pv2SmilesService(model, tok, k=2, stochastic=True, seed=7,
                              batch_size=4, max_wait_ms=50.0,
                              device=CPU) as svc:
            return svc.map(list(pvs))

    first, second = run(), run()
    assert all(isinstance(s, str) for s in first)
    assert first == second


@pytest.fixture(scope="module")
def served(tiny):
    model, tok = tiny
    stats = PropertyStats.load()
    services = {
        "pv2smiles": Pv2SmilesService(model, tok, k=2, batch_size=4,
                                      max_wait_ms=30.0, device=CPU),
        "smiles2pv": Smiles2PvService(model, tok, stats=stats, batch_size=4,
                                      max_wait_ms=30.0, max_len=24,
                                      device=CPU),
    }
    server = make_server(services, "127.0.0.1", 0, stats=stats)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", model, tok, stats
    server.shutdown()
    server.server_close()
    for svc in services.values():
        svc.close()


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_route_matches_offline_and_healthz_counts(served):
    url, model, tok, stats = served
    _, before = _healthz(url)
    pvs = np.random.default_rng(0).normal(size=(3, 53)).astype(np.float32)
    want = generate_batched(model, tok, pvs, k=2, seed=0, device_batch=4,
                            device=CPU)
    got = []
    for pv in pvs:
        status, body = _post(url, "/pv2smiles",
                             {"pv": [float(v) for v in pv],
                              "normalized": True})
        assert status == 200
        got.append(body["smiles"])
    assert got == want
    raw = stats.denormalize(pvs[0])
    status, body = _post(url, "/pv2smiles", {"pv": [float(v) for v in raw]})
    assert status == 200 and isinstance(body["smiles"], str)
    status, after = _healthz(url)
    assert status == 200 and after["ok"]
    assert set(after["services"]) == {"pv2smiles", "smiles2pv"}
    assert (after["services"]["pv2smiles"]["requests"]
            - before["services"]["pv2smiles"]["requests"]) == 4


def test_route_partial_conditioning(served):
    url = served[0]
    pv = [float(v) for v in
          np.random.default_rng(5).normal(size=53).astype(np.float32)]
    nulled = pv[:20] + [None] * 33
    status, body = _post(url, "/pv2smiles", {"pv": nulled, "normalized": True})
    assert status == 200 and isinstance(body["smiles"], str)
    mask = [0] * 20 + [1] * 33
    status2, body2 = _post(url, "/pv2smiles",
                           {"pv": pv[:20] + [0.0] * 33, "mask": mask,
                            "normalized": True})
    assert status2 == 200 and body2["smiles"] == body["smiles"]
    status3, body3 = _post(url, "/pv2smiles",
                           {"pv": pv[:20] + [1e6] * 33, "mask": mask,
                            "normalized": True})
    assert status3 == 200 and body3["smiles"] == body["smiles"]
    status4, body4 = _post(url, "/pv2smiles", {"pv": nulled})
    assert status4 == 200 and isinstance(body4["smiles"], str)


@pytest.mark.parametrize("path,payload,code", [
    ("/pv2smiles", {"pv": [1.0, 2.0]}, 400),
    ("/pv2smiles", {"pv": [1.0] * 53, "mask": [1] * 5, "normalized": True},
     400),
    ("/pv2smiles", {"pv": [1.0] * 53, "mask": [0.5] * 53,
                    "normalized": True}, 400),
    ("/pv2smiles", {"smiles": "CCO"}, 400),
    ("/smiles2pv", {"smiles": ""}, 400),
    ("/smiles2pv", {"smiles": 5}, 400),
    ("/smiles2pv", {"pv": [1.0] * 53}, 400),
    ("/nope", {}, 404),
])
def test_validation_errors(served, path, payload, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served[0], path, payload)
    assert e.value.code == code


def test_smiles2pv_route_matches_offline(served):
    """POST /smiles2pv answers the denormalized offline prediction
    (tests/test_serve_cli.py:102) and /healthz counts the requests."""
    from spmm_tpu_torch.inference.smiles2pv import predict_pv

    url, model, tok, stats = served
    smiles = ["CCO", "c1ccccc1"]
    ids, mask = tok.encode_batch(["[CLS]" + s for s in smiles], max_len=24,
                                 buckets=(24,))
    want = stats.denormalize(predict_pv(model, ids, mask,
                                        device=CPU).numpy())
    _, before = _healthz(url)
    for i, s in enumerate(smiles):
        status, body = _post(url, "/smiles2pv", {"smiles": s})
        assert status == 200 and len(body["pv"]) == 53
        np.testing.assert_allclose(np.asarray(body["pv"], np.float32),
                                   want[i], atol=1e-4, rtol=1e-4)
    _, after = _healthz(url)
    assert (after["services"]["smiles2pv"]["requests"]
            - before["services"]["smiles2pv"]["requests"]) == 2


def test_concurrent_clients_coalesce(served):
    url = served[0]
    pvs = np.random.default_rng(1).normal(size=(4, 53)).astype(np.float32)
    out = {}

    def client(i):
        status, body = _post(url, "/pv2smiles",
                             {"pv": [float(v) for v in pvs[i]],
                              "normalized": True})
        out[i] = (status, body["smiles"])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120.0)
        assert not th.is_alive()
    assert all(out[i][0] == 200 and isinstance(out[i][1], str)
               for i in range(4))


def test_generate_with_property_conditions_on_the_unmasked(tiny):
    """Single-query workload: deterministic searches over one condition are
    identical, and the mask decides which values matter."""
    from spmm_tpu_torch.inference.pv2smiles import generate_with_property

    model, tok = tiny
    rng = np.random.default_rng(9)
    pv = rng.normal(size=53).astype(np.float32)
    mask = np.zeros(53, np.float32)
    mask[10:] = 1.0
    other = pv.copy()
    other[10:] = rng.normal(size=43)
    runs = [generate_with_property(model, tok, p, mask, n_generate=3, k=2,
                                   stochastic=False, device_batch=2,
                                   device=CPU) for p in (pv, other)]
    assert len(runs[0]) == 3 and len(set(runs[0])) == 1
    assert runs[0] == runs[1]
    sampled = generate_with_property(model, tok, pv, mask, n_generate=4, k=2,
                                     seed=5, device_batch=4, device=CPU)
    assert sampled == generate_with_property(model, tok, pv, mask,
                                             n_generate=4, k=2, seed=5,
                                             device_batch=4, device=CPU)
