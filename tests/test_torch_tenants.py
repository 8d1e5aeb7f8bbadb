"""The port's tenant layer (`parallel/tenants.py`) against the JAX
package's and against zlib.

The vectorized CRC32 must be bit-identical to `zlib.crc32` (the hash
`shard_of_key` uses) and to the JAX twin, `prefix_lens` and
`key_matrix` must give the JAX arrays, and the registry must hand out
the same dense ids, collapse the same overflow namespaces into id 0,
refuse the same bad arguments and report the same stats.
"""

import zlib

import numpy as np
import pytest

from throttlecrab_tpu.parallel import sharded as jax_sharded
from throttlecrab_tpu.parallel import tenants as jax_tenants
from throttlecrab_tpu_torch.parallel import sharded as port_sharded
from throttlecrab_tpu_torch.parallel import tenants as port_tenants


def _keys(seed, n=300):
    rng = np.random.default_rng(seed)
    return [
        bytes(rng.integers(0, 256, rng.integers(0, 40), dtype=np.uint8))
        for _ in range(n)
    ] + [b"", b":", b"t0:", b"plain-key", b"x" * 300, b"acme:user:1"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_vectorized_crc32_matches_zlib_and_jax(seed):
    keys = _keys(seed)
    mat, lens = port_tenants.key_matrix(keys)
    jmat, jlens = jax_tenants.key_matrix(keys)
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_array_equal(lens, jlens)
    got = port_tenants.crc32_rows(mat, lens)
    want = np.array([zlib.crc32(k) for k in keys], np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_tenants.crc32_rows(jmat, jlens))
    for D in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            (got % np.uint32(D)).astype(np.int32),
            np.array(
                [port_sharded.shard_of_key(k, D) for k in keys], np.int32
            ),
        )
        assert [port_sharded.shard_of_key(k, D) for k in keys] == [
            jax_sharded.shard_of_key(k, D) for k in keys
        ]


@pytest.mark.parametrize("delim", [":", "/", "\x00"])
def test_prefix_lens_as_in_jax(delim):
    d = delim.encode()
    keys = [b"acme" + d + b"user" + d + b"1", b"no-delim", d + b"leading",
            b"", b"acme" + d + b"x", d, b"a" + d] + _keys(5, 50)
    mat, lens = port_tenants.key_matrix(keys)
    got = port_tenants.prefix_lens(mat, lens, d[0])
    want = jax_tenants.prefix_lens(mat, lens, d[0])
    np.testing.assert_array_equal(got, want)
    assert got[:5].tolist() == [4, 0, 0, 0, 4]


def test_key_matrix_refuses_what_jax_refuses():
    for mod in (port_tenants, jax_tenants):
        with pytest.raises(mod.KeyTooLong):
            mod.key_matrix([b"x" * (mod.MATRIX_MAX_KEY + 1), b"small"])
        with pytest.raises(TypeError):
            mod.key_matrix([b"ok", ("exotic", 1)])
    assert port_tenants.MATRIX_MAX_KEY == jax_tenants.MATRIX_MAX_KEY


def test_registry_ids_overflow_and_stats_as_in_jax():
    regs = [mod.TenantRegistry(max_tenants=6)
            for mod in (port_tenants, jax_tenants)]
    names = [b"acme", b"", b"beta", b"acme", b"\xff\xfe", b"gamma",
             b"delta", b"one-too-many", b"x" * 100, b"beta"]
    ids = [[r.tid_of(n) for n in names] for r in regs]
    assert ids[0] == ids[1]
    # acme gets one id, the default namespace another; past the bound
    # (5 names + the overflow bucket) extras collapse into id 0.
    assert ids[0][0] == ids[0][3] and ids[0][1] != ids[0][0]
    assert ids[0][7] == ids[0][8] == 0
    assert len(regs[0]) == len(regs[1]) == 6
    rng = np.random.default_rng(4)
    for _ in range(3):
        tc = rng.integers(0, 50, (6, 2))
        for r in regs:
            r.add_counts(tc)
    for r in regs:
        r.quota_rejections[2] += 7
    assert regs[0].stats() == regs[1].stats()
    assert port_tenants.OVERFLOW_TENANT in regs[0].stats()
    assert port_tenants.DEFAULT_TENANT == jax_tenants.DEFAULT_TENANT


@pytest.mark.parametrize("kw", [
    {"max_tenants": 1}, {"max_tenants": 0}, {"delim": ""},
    {"delim": "::"}, {"delim": "é"}, {"quota_frac": -0.1},
    {"quota_frac": 1.5},
], ids=["one", "zero", "empty-delim", "two-byte-delim", "utf8-delim",
        "quota-negative", "quota-high"])
def test_registry_refuses_what_jax_refuses(kw):
    for mod in (port_tenants, jax_tenants):
        with pytest.raises(ValueError):
            mod.TenantRegistry(**kw)


def test_registry_fields_as_in_jax():
    kw = dict(max_tenants=9, delim="/", quota_frac=0.25, affinity=True)
    a = port_tenants.TenantRegistry(**kw)
    b = jax_tenants.TenantRegistry(**kw)
    for name in ("max_tenants", "delim", "delim_byte", "quota_frac",
                 "affinity"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.counts.shape == b.counts.shape == (9, 2)
    assert a.quota_rejections.shape == b.quota_rejections.shape
