"""``repro_torch.core.device_bloom`` (the batched Bloom query on torch
tensors) against ``repro.core.jax_bloom`` and the Python ``BloomFilter``,
bit for bit: the MurmurHash3 words, the hashes and every membership
answer, on the property strategy of ``tests/test_bloom.py`` and on seeded
batches of keys across filter sizes, hash counts and seeds."""

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core.bloom import BloomFilter as JBloomFilter
from repro.core.bloom import encode_mnk, murmur3_32
from repro.core.jax_bloom import bloom_query as j_bloom_query
from repro.core.jax_bloom import mnk_to_words as j_mnk_to_words
from repro.core.jax_bloom import murmur3_32_words as j_murmur3_32_words
from repro.core.jax_bloom import query_filters as j_query_filters
from repro_torch.core import device_bloom
from repro_torch.core.bloom import BloomFilter

sizes_strategy = st.lists(
    st.tuples(
        st.integers(min_value=1, max_value=2**20),
        st.integers(min_value=1, max_value=2**20),
        st.integers(min_value=1, max_value=2**20),
    ),
    min_size=1,
    max_size=64,
)


def _filters(capacity, fp_rate, seed, keys):
    """The port's filter and ``repro``'s, the first half of ``keys`` added."""
    bf, jbf = (cls.for_capacity(capacity, fp_rate, seed=seed)
               for cls in (BloomFilter, JBloomFilter))
    for m, n, k in keys[: len(keys) // 2 or 1]:
        bf.add_mnk(int(m), int(n), int(k))
        jbf.add_mnk(int(m), int(n), int(k))
    assert bytes(bf.bits) == bytes(jbf.bits)
    return bf, jbf


def _check(keys, capacity=500, fp_rate=0.02, seed=5):
    keys = [tuple(int(v) for v in key) for key in keys]
    bf, jbf = _filters(capacity, fp_rate, seed, keys)
    ms, ns, ks = (np.array([key[i] for key in keys]) for i in range(3))
    tm, tn, tk = (torch.as_tensor(a) for a in (ms, ns, ks))
    words = device_bloom.mnk_to_words(tm, tn, tk)
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_mnk_to_words(ms, ns, ks)))
    got_h = device_bloom.murmur3_32_words(words, seed).numpy()
    np.testing.assert_array_equal(got_h, np.asarray(j_murmur3_32_words(
        j_mnk_to_words(ms, ns, ks), np.uint32(seed))).astype(np.int64))
    np.testing.assert_array_equal(got_h, [murmur3_32(encode_mnk(*key), seed) for key in keys])
    got = device_bloom.bloom_query(bf.bits, bf.n_bits, bf.n_hashes, bf.seed, tm, tn, tk)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_bloom_query(
        jbf.bits, jbf.n_bits, jbf.n_hashes, jbf.seed, ms, ns, ks)))
    np.testing.assert_array_equal(got.numpy(), [bf.query_mnk(*key) for key in keys])
    return got


@settings(max_examples=20, deadline=None)
@given(sizes_strategy)
def test_device_bloom_bit_exact(sizes):
    _check(sizes)


@pytest.mark.parametrize("capacity,fp_rate,seed", [(500, 0.02, 5), (64, 0.3, 0),
                                                   (10_000, 0.001, 2**32 - 1), (7, 0.5, 77)])
def test_device_bloom_bit_exact_on_seeded_keys(capacity, fp_rate, seed):
    keys = np.random.default_rng(seed % 1000).integers(1, 2**31 - 1, (400, 3))
    got = _check(keys, capacity, fp_rate, seed)
    assert got[:200].all()  # every added key answers "possibly present"


def test_query_filters_matches_repro():
    keys = np.random.default_rng(9).integers(1, 2**20, (300, 3))
    pairs = [_filters(200, 0.05, s, [tuple(k) for k in keys[i::3]]) for i, s in
             enumerate((0, 1, 2))]
    got = device_bloom.query_filters([p for p, _ in pairs], *(torch.as_tensor(keys[:, i])
                                                             for i in range(3)))
    want = np.asarray(j_query_filters([j for _, j in pairs], *(keys[:, i] for i in range(3))))
    assert got.shape == (300, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_flipped_key_bit_changes_its_hash():
    """What the chip check's planted fault relies on: one bit of one key
    flipped moves its hash."""
    keys = torch.as_tensor(np.random.default_rng(4).integers(1, 2**20, (50, 3)))
    h = device_bloom.murmur3_32_words(device_bloom.mnk_to_words(*keys.T), 0)
    flipped = keys.clone()
    flipped[17, 1] ^= 1 << 5
    g = device_bloom.murmur3_32_words(device_bloom.mnk_to_words(*flipped.T), 0)
    assert (g != h).nonzero().flatten().tolist() == [17]
