"""Smith-Waterman parity tests.

Mirrors the reference's batch test (src/test_sw_score.cpp:17-69): score 100
adjacent pairs from the fixture windows and compare against the scalar DP
oracle (transliteration of metrics.cpp:10-45).
"""

import numpy as np

from deepreadmapper_tpu.ops import sw
from deepreadmapper_tpu.tokenizer import strings_to_bytes


def test_simple_pairs():
    assert sw.sw_score_pair("ACGT", "ACGT") == 4
    assert sw.sw_score_pair("ACGT", "TTTT") == 1  # single T matches
    assert sw.sw_score_pair("AAAA", "CCCC") == 0
    assert sw.sw_score_pair("ACGTACGT", "ACGAACGT") == sw.sw_score_reference(
        "ACGTACGT", "ACGAACGT"
    )


def test_gap_handling():
    # Deletion: ACGTACGT vs ACGACGT -> 7 matches with one gap: 7 - 1 = 6.
    s = sw.sw_score_pair("ACGTACGT", "ACGACGT")
    assert s == sw.sw_score_reference("ACGTACGT", "ACGACGT") == 6


def test_wrapped_query_vs_unwrapped_candidate():
    # The pipeline scores '<'-wrapped queries against raw windows; the wrap
    # chars mismatch, exactly like the reference.
    cand = "ACGTACGTAC"
    query = "<ACGTACGTAC>"
    assert sw.sw_score_pair(cand, query) == sw.sw_score_reference(cand, query)


def test_batch_matches_reference_on_fixture_pairs(data_dir):
    from deepreadmapper_tpu.io.readers import read_txt

    seqs = read_txt(str(data_dir / "test_data_quer.txt"))[:40]
    pairs = [(seqs[i], seqs[i + 1]) for i in range(len(seqs) - 1)]
    a_mat, a_lens = strings_to_bytes([p[0] for p in pairs])
    b_mat, b_lens = strings_to_bytes([p[1] for p in pairs])
    got = sw.sw_scores(a_mat, a_lens, b_mat, b_lens)
    want = np.array([sw.sw_score_reference(a, b) for a, b in pairs])
    np.testing.assert_array_equal(got, want)


def test_variable_lengths_in_batch():
    rng = np.random.default_rng(3)
    alphabet = np.array(list("ACGT"))
    seqs_a = ["".join(rng.choice(alphabet, size=n)) for n in [5, 20, 150, 1, 73]]
    seqs_b = ["".join(rng.choice(alphabet, size=n)) for n in [150, 3, 7, 99, 73]]
    a_mat, a_lens = strings_to_bytes(seqs_a)
    b_mat, b_lens = strings_to_bytes(seqs_b)
    got = sw.sw_scores(a_mat, a_lens, b_mat, b_lens)
    want = np.array([sw.sw_score_reference(a, b) for a, b in zip(seqs_a, seqs_b)])
    np.testing.assert_array_equal(got, want)


def test_chunking_consistency():
    rng = np.random.default_rng(4)
    alphabet = np.array(list("ACGT"))
    seqs = ["".join(rng.choice(alphabet, size=30)) for _ in range(10)]
    a_mat, a_lens = strings_to_bytes(seqs)
    got_small = sw.sw_scores(a_mat, a_lens, a_mat[::-1].copy(), a_lens[::-1], chunk=3)
    got_big = sw.sw_scores(a_mat, a_lens, a_mat[::-1].copy(), a_lens[::-1])
    np.testing.assert_array_equal(got_small, got_big)


def test_sw_batch_matches_scalar_dp_mixed_lengths():
    """Batched SW (ops/sw.py) over rows of mixed true lengths equals the
    scalar DP transliteration row by row."""
    from deepreadmapper_tpu.tokenizer import strings_to_bytes

    rng = np.random.default_rng(5)
    alphabet = np.array(list("ACGT"))
    a = ["".join(rng.choice(alphabet, n)) for n in [150, 150, 30, 150]]
    b = ["".join(rng.choice(alphabet, n)) for n in [152, 40, 152, 152]]
    am, al = strings_to_bytes(a)
    bm, bl = strings_to_bytes(b)
    got = sw.sw_scores(am, al, bm, bl)
    want = [sw.sw_score_reference(x, y) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, want)


def test_sw_wrapped_query_matches_scalar_dp():
    from deepreadmapper_tpu.tokenizer import strings_to_bytes

    cand = "ACGTACGTACGTACGTACGT"
    query = "<" + cand + ">"
    am, al = strings_to_bytes([cand])
    bm, bl = strings_to_bytes([query])
    got = sw.sw_scores(am, al, bm, bl)
    assert got[0] == sw.sw_score_reference(cand, query)
