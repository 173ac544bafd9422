import numpy as np

from emsar_jax.index import pack
from emsar_jax.index.kernels import run_lengths, sort_runs
from emsar_jax.io.fasta import build_transcriptome


def _keys_bruteforce(seq: bytes, positions, rl):
    return [seq[p:p + rl] for p in positions]


def test_window_words_match_string_order():
    rng = np.random.default_rng(1)
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=500).tobytes()
    tx = build_transcriptome(["x"], [seq])
    p16 = pack.pack16(tx.codes)
    for rl in (5, 16, 17, 33, 76):
        positions = np.arange(0, tx.borderpos - rl + 1, dtype=np.int64)
        bad = pack.bad_prefix(tx.codes)
        positions = positions[pack.valid_windows(bad, positions, rl)]
        words = pack.window_words_np(p16, positions, rl)
        strs = _keys_bruteforce(tx.seq.tobytes(), positions, rl)
        # word-order == string-order
        order_w = sorted(range(len(positions)),
                         key=lambda i: tuple(words[i]))
        order_s = sorted(range(len(positions)), key=lambda i: strs[i])
        assert [strs[i] for i in order_w] == [strs[i] for i in order_s]
        # word-equality == string-equality
        seen = {}
        for i in range(len(positions)):
            k = tuple(words[i])
            if k in seen:
                assert strs[seen[k]] == strs[i]
            seen[k] = i


def test_valid_windows():
    tx = build_transcriptome(["a", "b"], [b"ACGNACG", b"TTTT"])
    bad = pack.bad_prefix(tx.codes)
    rl = 3
    pos = np.arange(0, tx.seqlength - rl + 1)
    v = pack.valid_windows(bad, pos, rl)
    seq = tx.seq.tobytes()
    for p, ok in zip(pos, v):
        expect = all(c in b"ACGT" for c in seq[p:p + rl])
        assert ok == expect, (p, seq[p:p + rl])


def test_lexmin_and_cmp():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 4, size=(100, 3)).astype(np.uint32)
    b = rng.integers(0, 4, size=(100, 3)).astype(np.uint32)
    cmp, mn = pack.lexmin_words_np(a, b)
    for i in range(100):
        ta, tb = tuple(a[i]), tuple(b[i])
        expect = -1 if ta < tb else (1 if ta > tb else 0)
        assert cmp[i] == expect
        assert tuple(mn[i]) == min(ta, tb)


def test_sort_runs_backends_agree():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 3, size=(257, 2)).astype(np.uint32)
    aux = rng.integers(0, 1000, size=(257, 1)).astype(np.int32)
    swj, saj, ridj = sort_runs(words, aux, 2, backend="jax")
    swn, san, ridn = sort_runs(words, aux, 2, backend="numpy")
    assert np.array_equal(swj, swn)
    assert np.array_equal(ridj, ridn)
    # runs group identical keys
    for rid in (ridj, ridn):
        lens = run_lengths(rid)
        assert lens.sum() == 257
    # aux rows stay attached to their key rows (multisets per run match)
    for r in range(int(ridj[-1]) + 1):
        mj = np.sort(saj[ridj == r, 0])
        mn = np.sort(san[ridn == r, 0])
        assert np.array_equal(mj, mn)
