"""Port parity: the training data path of spmm_tpu_torch vs spmm_tpu — the
host batchers (``batch_supervised``, ``batch_pairs``, ``prefetch``), the ten
MoleculeNet / DILI loaders (the port reads CSVs with the ``csv`` module,
JAX with pandas) and ``MetricLogger``.  Everything is exact: the same
arrays, texts, targets and records for the same files and seeds.
"""

import json
import os

import numpy as np
import pytest

from spmm_tpu.data import datasets as jdata
from spmm_tpu.data import pipeline as jpipe
from spmm_tpu.tokenizer import SmilesTokenizer as JTok
from spmm_tpu.utils.logging import MetricLogger as JLogger

from spmm_tpu_torch.data import datasets, pipeline
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smiles(n):
    with open(os.path.join(REPO, "examples", "s2p_input.txt")) as f:
        smiles = [line.strip() for line in f if line.strip()]
    return [smiles[i % len(smiles)] for i in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]), err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3, drop_last=True),
    dict(shuffle=True, seed=4, pad_batch=True, truncation=False),
    dict(shuffle=False, buckets=(16, 48), max_len=48),
], ids=["train", "eval_no_truncation", "buckets"])
def test_batch_supervised_matches_jax(kw):
    texts = ["[CLS]" + s for s in _smiles(23)]
    texts[5] = "[CLS]" + ".".join(_smiles(5))        # past every bucket
    targets = np.arange(23, dtype=np.float32) * 0.5
    got = list(pipeline.batch_supervised(SmilesTokenizer(), texts, targets,
                                         5, **kw))
    want = list(jpipe.batch_supervised(JTok(), texts, targets, 5, **kw))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=7),
                                dict(shuffle=False, drop_last=False)])
def test_batch_pairs_matches_jax(tmp_path, kw):
    path = tmp_path / "train_parsed.txt"
    srcs = [".".join(_smiles(i % 4 + 1 + i)[i:]) for i in range(11)]
    # past the largest bucket (256): a word is at most 250 characters, so a
    # text this long has many words, each further word one token; row 4
    # is in a kept batch of both orders
    srcs[4] = _smiles(1)[0] + " C" * 300
    path.write_text("".join(f"{s}\t{s.split('.')[0]}\n" for s in srcs))
    got = list(pipeline.batch_pairs(
        SmilesTokenizer(), datasets.USPTODataset(str(path)), 4, **kw))
    want = list(jpipe.batch_pairs(JTok(), jdata.USPTODataset(str(path)), 4,
                                  **kw))
    _assert_batches_equal(got, want)
    assert max(b["src_ids"].shape[1] for b in got) == 320


def test_prefetch_keeps_order_and_raises():
    assert list(pipeline.prefetch(iter(range(20)), depth=3)) == list(
        range(20))

    def broken():
        yield 1
        raise KeyError("bad item")

    it = pipeline.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad item"):
        next(it)


def _write(path, header, rows):
    """A CSV as pandas' users write it: quoted fields where needed, a blank
    line at the end."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
        f.write("\n")


def _loader_files(tmp_path):
    s = _smiles(9)
    out = {
        "bace": (["mol", "CID", "Class"],
                 [[x, f"id{i}", i % 2] for i, x in enumerate(s)]),
        "bbbp": (["num", "name", "p_np", "smiles"],
                 [[i, f"n{i}", (i + 1) % 2, x] for i, x in enumerate(s)]
                 + [[99, "bad", 1, "C(C"]]),
        "lidi": (["Smiles", "Liver"], [[x, i % 2] for i, x in enumerate(s)]),
        "bace_r": (["smiles", "target"],
                   [[x, 5.0 + 0.37 * i] for i, x in enumerate(s)]),
        "lipo": (["CMPD_CHEMBLID", "exp", "smiles"],
                 [[f"c{i}", f"{-1.2 + i * 0.41:.2f}", x]
                  for i, x in enumerate(s)]),
        "clearance": (["smiles", "target"],
                      [[x, 12 * i + 0.5] for i, x in enumerate(s)]),
        "esol": (["Compound ID",
                  "ESOL predicted log solubility in mols per litre",
                  "smiles"],
                 [[f"c{i}", f"{-3.1 + i / 7:.6g}", x]
                  for i, x in enumerate(s)]),
        "freesolv": (["smiles", "target"],
                     [[x, f"{-2.5 - i * 1.3e-1}"] for i, x in enumerate(s)]),
        "clintox": (["smiles", "FDA_APPROVED", "CT_TOX"],
                    [[x, i % 2, (i // 2) % 2] for i, x in enumerate(s)]),
        "sider": (["smiles", "Hepatobiliary disorders",
                   "Injury, poisoning and procedural complications",
                   "Eye disorders", "Investigations"],
                  [[x, i % 2, (i + 1) % 2, (i // 3) % 2, 1]
                   for i, x in enumerate(s)]),
    }
    paths = {}
    for name, (header, rows) in out.items():
        paths[name] = str(tmp_path / f"{name}.csv")
        _write(paths[name], header, rows)
    return paths


def test_downstream_loaders_match_jax(tmp_path):
    assert sorted(datasets.DOWNSTREAM_LOADERS) == sorted(
        jdata.DOWNSTREAM_LOADERS)
    assert datasets.LABEL_STATS == jdata.LABEL_STATS
    for name, path in _loader_files(tmp_path).items():
        got = datasets.DOWNSTREAM_LOADERS[name](path)
        want = jdata.DOWNSTREAM_LOADERS[name](path)
        assert got.texts == want.texts, name
        assert got.targets.dtype == want.targets.dtype, name
        np.testing.assert_array_equal(got.targets, want.targets, err_msg=name)
        assert (got.value_mean, got.value_std, got.n_output, len(got)) == (
            want.value_mean, want.value_std, want.n_output, len(want)), name
    assert len(datasets.load_bbbp(str(tmp_path / "bbbp.csv"))) == 9
    fs = datasets.load_freesolv(str(tmp_path / "freesolv.csv"))
    assert abs(fs.targets[0] - (-2.5 - fs.value_mean) / fs.value_std) < 1e-6


def test_loaders_raise_on_an_unparseable_smiles(tmp_path):
    path = str(tmp_path / "esol.csv")
    _write(path, ["smiles", "ESOL predicted log solubility in mols per litre"],
           [["CCO", 1.0], ["C(C", 2.0]])
    with pytest.raises(ValueError, match="unparseable"):
        datasets.load_esol(path)
    with pytest.raises(ValueError, match="unparseable"):
        jdata.load_esol(path)


def test_metric_logger_matches_jax(tmp_path):
    records = []
    for cls, name in ((MetricLogger, "port"), (JLogger, "jax")):
        logger = cls(str(tmp_path / name / "metrics.jsonl"), window=2)
        for step in range(3):
            logger.log(step + 1, {"loss": 1.0 / (step + 1), "lr": 1e-4})
        records.append((logger.summary(), logger.mean("missing")))
        logger.close()
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        records.append([{k: v for k, v in json.loads(line).items()
                         if k != "time"} for line in lines])
    assert records[0][0] == records[2][0]
    assert np.isnan(records[0][1]) and np.isnan(records[2][1])
    assert records[1] == records[3] and len(records[1]) == 3
