"""The port's streaming checkpoint loader (paddle_tpu_torch.models.
load_quant_serving_params over its own safetensors reader) against the
JAX loader (paddle_tpu.models.load_quant_serving_params over the
``safetensors`` package) on the CPU.

Files come from ``safetensors.torch.save_file`` (HF names, torch [out,
in] projections), as in tests/test_checkpoint_stream.py, on a 2-layer
tiny Llama. Every case must give BYTE-identical params (dtype, shape and
bits) to the JAX loader's: a single file, a sharded dir with its index,
a dir without one (a name in two shards resolves to the later file, with
a warning), a dict and a callable source under each naming, weights
stored in bf16, f16 and f32, quant None / int8 / int4. The reader's own
parse must equal ``safe_open`` on every dtype; malformed files raise
ValueError naming the file and the tensor; a missing name raises the
JAX loader's KeyError text; injected shard-read faults retry with the
JAX package's events; and an engine serving the loaded int8 params
gives the JAX engine's tokens.
"""
import json
import os
import struct
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import load_quant_serving_params as jax_load
from paddle_tpu.models.checkpoint import \
    _SafetensorsSource as JaxSafetensorsSource
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.models import LlamaConfig, load_quant_serving_params
from paddle_tpu_torch.models.checkpoint import (SAFETENSORS_DTYPES,
                                                _SafetensorsSource)
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.retry import RetryPolicy
from paddle_tpu_torch.serving import ContinuousBatchingEngine

DIMS = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
QUANTS = [None, "weight_only_int8", "weight_only_int4"]
STORED = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(**DIMS)
    paddle.seed(31)
    jm = JaxModel(jcfg)
    ours = {k: np.asarray(v.numpy(), np.float32)
            for k, v in jm.state_dict().items()}
    return jcfg, LlamaConfig(**DIMS), ours


def _hf(ours, stored=torch.float32):
    """Our names / [in, out] layout -> HF names / [out, in] torch."""
    sd = {}
    for k, v in ours.items():
        hk = "model." + k[len("llama."):] if k.startswith("llama.") else k
        t = torch.from_numpy(v.copy())
        if t.ndim == 2 and "embed_tokens" not in hk:
            t = t.T.contiguous()
        sd[hk] = t.to(stored)
    return sd


def _np(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy(), "bfloat16"
        return v.numpy(), str(v.numpy().dtype)
    a = np.asarray(v)
    if str(a.dtype) == "bfloat16":
        return a.view(np.int16), "bfloat16"
    return a, str(a.dtype)


def _assert_identical(ours, theirs):
    assert set(ours) == set(theirs)
    for k, want in theirs.items():
        got = ours[k]
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        assert isinstance(got, tuple) == isinstance(want, tuple), k
        for g, w in pairs:
            (ga, gd), (wa, wd) = _np(g), _np(w)
            assert gd == wd and ga.shape == wa.shape, (k, gd, wd)
            np.testing.assert_array_equal(ga, wa, err_msg=k)


def _both(jcfg, cfg, source, quant, jsource=None, **kw):
    return (load_quant_serving_params(cfg, source, quant, device="cpu",
                                      dtype=torch.float32, **kw),
            jax_load(jcfg, source if jsource is None else jsource, quant,
                     dtype=jnp.float32, **kw))


@pytest.mark.parametrize("stored", list(STORED))
@pytest.mark.parametrize("quant", QUANTS, ids=["dense", "int8", "int4"])
def test_single_file_identical_to_jax(model, tmp_path, quant, stored):
    jcfg, cfg, ours = model
    path = str(tmp_path / "model.safetensors")
    save_file(_hf(ours, STORED[stored]), path)
    _assert_identical(*_both(jcfg, cfg, path, quant))


@pytest.mark.parametrize("quant", QUANTS, ids=["dense", "int8", "int4"])
def test_sharded_dir_with_index_identical_to_jax(model, tmp_path, quant):
    jcfg, cfg, ours = model
    sd = _hf(ours, torch.bfloat16)
    names = sorted(sd)
    weight_map = {}
    for i, part in enumerate(np.array_split(names, 3)):
        fname = f"model-{i + 1:05d}-of-00003.safetensors"
        save_file({k: sd[k] for k in part}, str(tmp_path / fname))
        weight_map.update({k: fname for k in part})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map},
                  f)
    _assert_identical(*_both(jcfg, cfg, str(tmp_path), quant))


def test_dir_without_index_duplicate_resolves_to_later_file(model,
                                                            tmp_path):
    """Without an index every *.safetensors file is read in sorted
    order; a name in two files resolves to the later one (the JAX
    reader's rule), with a warning naming both files."""
    jcfg, cfg, ours = model
    sd = _hf(ours, torch.bfloat16)
    names = sorted(sd)
    dup = "model.layers.0.mlp.down_proj.weight"
    save_file({k: sd[k] for k in names[:10]}, str(tmp_path / "a.safetensors"))
    rest = {k: sd[k] for k in names[10:]}
    rest[dup] = sd[dup] * 2     # the later file's copy differs
    save_file(rest, str(tmp_path / "b.safetensors"))
    assert dup in names[:10]
    with pytest.warns(UserWarning, match="a.safetensors and b.safetensors"):
        got, want = _both(jcfg, cfg, str(tmp_path), "weight_only_int8")
    _assert_identical(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = load_quant_serving_params(
            cfg, {k: v for k, v in ours.items()}, "weight_only_int8",
            device="cpu")
    assert not torch.equal(got["llama.layers.0.mlp.down_proj.weight"][1],
                           again["llama.layers.0.mlp.down_proj.weight"][1])


@pytest.mark.parametrize("kind", ["dict-ours", "dict-hf", "callable-ours",
                                  "callable-hf"])
def test_dict_and_callable_sources_identical_to_jax(model, kind):
    jcfg, cfg, ours = model
    src_kind, names = kind.split("-")
    arrays = ours if names == "ours" else {
        k: v.numpy() for k, v in _hf(ours).items()}
    source = arrays if src_kind == "dict" else (lambda k: arrays[k])
    for quant in QUANTS:
        _assert_identical(*_both(jcfg, cfg, source, quant, names=names))


def test_shallow_cfg_reads_the_first_layers(model, tmp_path):
    jcfg, cfg, ours = model
    path = str(tmp_path / "model.safetensors")
    save_file(_hf(ours, torch.bfloat16), path)
    shallow = LlamaConfig(**{**DIMS, "num_hidden_layers": 1})
    got = load_quant_serving_params(shallow, path, "weight_only_int4",
                                    device="cpu")
    full = load_quant_serving_params(cfg, path, "weight_only_int4",
                                     device="cpu")
    assert not any(".layers.1." in k for k in got)
    for k, v in got.items():
        for a, b in zip(v, full[k]) if isinstance(v, tuple) \
                else [(v, full[k])]:
            assert torch.equal(a, b), k


def test_tied_embeddings_read_no_lm_head(model, tmp_path):
    jcfg, cfg, ours = model
    path = str(tmp_path / "model.safetensors")
    sd = _hf(ours)
    del sd["lm_head.weight"]
    save_file(sd, path)
    tied = LlamaConfig(**{**DIMS, "tie_word_embeddings": True})
    got = load_quant_serving_params(tied, path, "weight_only_int8",
                                    device="cpu")
    assert "lm_head.weight" not in got


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def _every_dtype():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f16": torch.randn(7, generator=g).half(),
        "f32": torch.randn(2, 3, 4, generator=g),
        "f64": torch.randn(3, dtype=torch.float64, generator=g),
        "i8": torch.randint(-128, 127, (9,), dtype=torch.int8, generator=g),
        "u8": torch.randint(0, 255, (4, 4), dtype=torch.uint8, generator=g),
        "i16": torch.arange(-3, 3, dtype=torch.int16),
        "u16": torch.arange(6, dtype=torch.int32).to(torch.uint16),
        "i32": torch.arange(5, dtype=torch.int32),
        "i64": torch.arange(5),
        "bool": torch.tensor([True, False, True]),
        "e4m3": torch.randn(6, generator=g).to(torch.float8_e4m3fn),
        "e5m2": torch.randn(6, generator=g).to(torch.float8_e5m2),
        "empty": torch.zeros(0, 4),
        "empty_bf16": torch.zeros(2, 0, dtype=torch.bfloat16),
        "scalar": torch.tensor(3.5),
    }


def test_reader_matches_safe_open_on_every_dtype(tmp_path):
    path = str(tmp_path / "all.safetensors")
    save_file(_every_dtype(), path, metadata={"format": "pt"})
    src = _SafetensorsSource(path)
    with safe_open(path, framework="pt") as f:
        keys = list(f.keys())
        assert sorted(src.keys()) == sorted(keys)
        for k in keys:
            got, want = src(k), f.get_tensor(k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.dtype in SAFETENSORS_DTYPES.values()
            if want.numel():
                assert torch.equal(got.reshape(-1).view(torch.uint8),
                                   want.reshape(-1).view(torch.uint8)), k


def _write(path, header, data=b"", pad=True):
    raw = json.dumps(header).encode()
    if pad:
        raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["truncated", "past_end", "wrong_size",
                                  "unknown_dtype", "reversed"])
def test_malformed_file_names_file_and_tensor(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    if case == "truncated":
        save_file({"w": torch.ones(64, 64), "tail": torch.ones(8)}, path)
        ends = {k: e.begin + e.nbytes
                for k, e in _SafetensorsSource(path)._by_name.items()}
        with open(path, "rb+") as f:
            f.truncate(os.path.getsize(path) - 100)
        name, match = max(ends, key=ends.get), "outside the file"
    else:
        meta = {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]}
        name, match = "t", {"past_end": "outside the file",
                            "wrong_size": "needs 16",
                            "unknown_dtype": "dtype 'Q7'",
                            "reversed": "outside the file"}[case]
        if case == "past_end":
            meta["data_offsets"] = [0, 32]
        elif case == "wrong_size":
            meta["data_offsets"] = [0, 12]
        elif case == "unknown_dtype":
            meta["dtype"] = "Q7"
        elif case == "reversed":
            meta["data_offsets"] = [16, 0]
        _write(path, {"__metadata__": {}, "t": meta}, bytes(16))
    with pytest.raises(ValueError) as ei:
        _SafetensorsSource(path)
    assert path in str(ei.value) and repr(name) in str(ei.value)
    assert match in str(ei.value)


def test_short_header_raises(tmp_path):
    path = str(tmp_path / "tiny.safetensors")
    with open(path, "wb") as f:
        f.write(b"\x01\x02")
    with pytest.raises(ValueError, match="too short"):
        _SafetensorsSource(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 1000) + b"{}")
    with pytest.raises(ValueError, match="runs past the end"):
        _SafetensorsSource(path)


def test_missing_name_raises_the_jax_keyerror(model, tmp_path):
    jcfg, cfg, ours = model
    path = str(tmp_path / "model.safetensors")
    save_file({"model.embed_tokens.weight": torch.zeros(4, 2),
               "model.norm.weight": torch.ones(2)}, path)
    errors = []
    for src in (_SafetensorsSource(path), JaxSafetensorsSource(path)):
        with pytest.raises(KeyError) as ei:
            src("model.norm.weigth")
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert "model.norm.weight" in errors[0] and "2 tensors" in errors[0]
    with pytest.raises(KeyError) as ours_e:
        load_quant_serving_params(cfg, {"wrong.name": np.zeros(2)}, None,
                                  device="cpu")
    with pytest.raises(KeyError) as jax_e:
        jax_load(jcfg, {"wrong.name": np.zeros(2)}, None)
    assert str(ours_e.value) == str(jax_e.value)
    assert "not found in the dict checkpoint source" in str(ours_e.value)


def test_index_naming_a_shard_without_the_tensor(tmp_path):
    save_file({"a": torch.ones(2)}, str(tmp_path / "s.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"a": "s.safetensors",
                                  "b": "s.safetensors"}}, f)
    src = _SafetensorsSource(str(tmp_path))
    assert torch.equal(src("a"), torch.ones(2))
    with pytest.raises(ValueError, match="does not hold it"):
        src("b")


# ---------------------------------------------------------------------------
# retries and chaos
# ---------------------------------------------------------------------------

def test_backoff_sequence_and_stats():
    slept = []
    policy = RetryPolicy(max_attempts=4, base_delay=0.1, multiplier=2.0,
                         jitter=0.0, sleep=slept.append, retry_on=(IOError,))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("blip")
        return 7

    assert policy.call(flaky) == 7
    assert slept == [0.1, 0.2]
    assert policy.stats.as_dict() == {
        "calls": 1, "attempts": 3, "retries": 2, "successes": 1,
        "giveups": 0, "last_error": "OSError: blip"}
    with pytest.raises(KeyError):       # not allowlisted: no retry
        policy.call(lambda: {}["x"])
    assert policy.stats.attempts == 4
    wrapped = RetryPolicy(max_attempts=2, sleep=slept.append)(lambda: 1)
    assert wrapped() == 1 and wrapped.retry_policy.stats.successes == 1


def test_jittered_delays_match_jax():
    from paddle_tpu.resilience.retry import RetryPolicy as JaxPolicy

    kw = dict(max_attempts=6, base_delay=0.05, jitter=0.3, seed=11)
    assert list(RetryPolicy(**kw).delays()) == list(JaxPolicy(**kw).delays())


@pytest.fixture
def registries():
    jreg, reg = jax_metrics.enable(), obs_metrics.enable()
    yield jreg, reg
    jax_metrics.disable()
    obs_metrics.disable()
    chaos.uninstall()
    jax_chaos.uninstall()
    set_flags({"io_retry_attempts": 3, "io_retry_base_delay_s": 0.05})
    paddle.set_flags({"io_retry_attempts": 3, "io_retry_base_delay_s": 0.05})


def _events(reg):
    return [{k: v for k, v in e.items() if k != "t"} for e in reg.events()]


def test_io_error_gives_up_with_the_jax_events(model, tmp_path, registries):
    jcfg, cfg, ours = model
    jreg, reg = registries
    path = str(tmp_path / "model.safetensors")
    save_file(_hf(ours), path)
    for flags in (set_flags, paddle.set_flags):
        flags({"io_retry_attempts": 3, "io_retry_base_delay_s": 0.001})
    chaos.install("io_error:1.0:shard_read")
    jax_chaos.install("io_error:1.0:shard_read")
    with pytest.raises(chaos.ChaosError):
        load_quant_serving_params(cfg, path, "weight_only_int8",
                                  device="cpu")
    with pytest.raises(jax_chaos.ChaosError):
        jax_load(jcfg, path, "weight_only_int8")
    ours_ev, jax_ev = _events(reg), _events(jreg)
    assert ours_ev == jax_ev
    assert [e["event"] for e in ours_ev] == [
        "chaos.io_error", "retry.backoff", "chaos.io_error",
        "retry.backoff", "chaos.io_error", "retry.giveup"]


def test_io_error_half_the_reads_retries_to_identical_params(
        model, tmp_path, registries):
    jcfg, cfg, ours = model
    jreg, reg = registries
    path = str(tmp_path / "model.safetensors")
    save_file(_hf(ours, torch.bfloat16), path)
    clean = load_quant_serving_params(cfg, path, "weight_only_int4",
                                      device="cpu", dtype=torch.float32)
    for flags in (set_flags, paddle.set_flags):
        flags({"io_retry_attempts": 30, "io_retry_base_delay_s": 1e-4})
    chaos.install("io_error:0.5:shard_read", seed=5)
    jax_chaos.install("io_error:0.5:shard_read", seed=5)
    policy = RetryPolicy(max_attempts=30, base_delay=1e-4)
    got = load_quant_serving_params(
        cfg, _SafetensorsSource(path, retry=policy), "weight_only_int4",
        names="hf", device="cpu", dtype=torch.float32)
    want = jax_load(jcfg, path, "weight_only_int4", dtype=jnp.float32)
    _assert_identical(got, want)
    _assert_identical(got, {k: v for k, v in clean.items()})
    assert policy.stats.retries > 0 and policy.stats.giveups == 0
    assert policy.stats.successes == len(got)
    assert chaos.counters()["io_error"] == policy.stats.retries
    assert [e["event"] for e in _events(reg)] \
        == [e["event"] for e in _events(jreg)]


# ---------------------------------------------------------------------------
# serving what was loaded
# ---------------------------------------------------------------------------

def test_engine_serves_loaded_params_like_jax(model, tmp_path):
    jcfg, cfg, ours = model
    path = str(tmp_path / "model.safetensors")
    save_file(_hf(ours), path)
    got, want = _both(jcfg, cfg, path, "weight_only_int8")
    kw = dict(slots=2, prompt_bucket=8, max_prompt_len=16,
              max_new_tokens=5, block_size=8, steps_per_sync=2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, DIMS["vocab_size"], (n,)).tolist()
               for n in (5, 9, 3)]
    jeng = JaxEngine(jcfg, want, dtype=jnp.float32, unified_step=False, **kw)
    eng = ContinuousBatchingEngine(cfg, got, device="cpu",
                                   dtype=torch.float32, **kw)
    jreqs = [jeng.add_request(p) for p in prompts]
    reqs = [eng.add_request(p) for p in prompts]
    jeng.run(max_iters=100)
    eng.run(max_iters=100)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert all(len(r.tokens) == 5 for r in reqs)
