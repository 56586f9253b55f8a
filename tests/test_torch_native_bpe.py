"""The port's native BPE (runtime/cpp/bpe.cpp behind runtime/tokenizer.BBPETokenizer)
against its own Python merge loop and the JAX package's tokenizer, token for token: text
drawn by hypothesis with the special tokens mixed in, a pretoken past the library's 4096
ids (the Python loop answers it), vocabs the library cannot hold (the Python path), the
pickled and threaded tokenizer; a failed g++ build raises with its stderr; and the
sanitizer smoke test (native/native_smoke.cpp) over the port's three native sources,
built with -fsanitize=address,undefined, runs to exit 0."""

import os
import pickle
import subprocess
import sys
import threading

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_flamingo_tpu.runtime import tokenizer as jtok
from audio_flamingo_tpu_torch.runtime import tokenizer as ttok

torch.set_num_threads(2)

CORPUS = ["describe the sound of music and speech", "It's a dog barking; don't panic!",
          "Ünïcödé naïve café 漢字 テスト ٣٤ 12345 ²", "tabs\tand\nnew\r\nlines   end  "]
SPECIALS = list(ttok.DEFAULT_SPECIAL_TOKENS)
LONG = "ж" * 2500   # one pretoken of 5000 byte-level pieces: no merge joins them
PKG = os.path.dirname(os.path.dirname(os.path.abspath(ttok.__file__)))


@pytest.fixture(scope="module")
def toks():
    vm = ttok.train_bpe(CORPUS, 430)
    native = ttok.BBPETokenizer(*vm)
    plain = ttok.BBPETokenizer(*vm, use_native=False)
    jax_tok = jtok.BBPETokenizer(*vm, use_native=False)
    return native, plain, jax_tok


def test_native_is_the_default(toks):
    native, plain, _ = toks
    assert native._native is not None and plain._native is None


TEXT = st.lists(st.one_of(st.text(max_size=24), st.sampled_from(SPECIALS),
                          st.sampled_from(CORPUS)), max_size=6).map("".join)


@settings(max_examples=200, deadline=None)
@given(text=TEXT, allow_special=st.booleans())
def test_native_equals_python_and_jax(toks, text, allow_special):
    native, plain, jax_tok = toks
    ids = native.encode(text, allow_special=allow_special)
    assert ids == plain.encode(text, allow_special=allow_special)
    assert ids == jax_tok.encode(text, allow_special=allow_special)


def test_pretoken_past_the_native_buffer_goes_through_python(toks):
    native, plain, jax_tok = toks
    mapped = "".join(native.byte_encoder[b] for b in LONG.encode("utf-8"))
    assert native._native.encode(mapped) is None          # more than NATIVE_MAX_IDS ids
    text = f"<sound>{CORPUS[0]} {LONG}, {CORPUS[2]}"
    ids = native.encode(text)
    assert len(ids) > ttok.NATIVE_MAX_IDS
    assert ids == plain.encode(text) == jax_tok.encode(text)
    # a short pretoken after it still takes the native path
    assert native._native.encode(native.byte_encoder[ord("d")]) == [native.vocab["d"]]


def test_vocabs_the_library_cannot_hold_keep_python(toks):
    vocab, merges = dict(toks[0].vocab), list(toks[0].merges)
    sparse = {k: (v if v < 10 else v + 5) for k, v in vocab.items()}   # ids not dense
    gap = ttok.BBPETokenizer(sparse, merges)
    assert gap._native is None
    assert gap.encode(CORPUS[1]) == jtok.BBPETokenizer(sparse, merges,
                                                       use_native=False).encode(CORPUS[1])
    multiline = dict(vocab, **{"a\nb": len(vocab)})
    assert ttok.BBPETokenizer(multiline, merges)._native is None
    assert not ttok.NativeBpe.supports(vocab, merges + [("a b", "c")])


def test_pickled_and_threaded(toks):
    """A pickled copy builds its own table; one table shared by more threads than cores,
    with a short switch interval, gives every thread the Python loop's ids (its cache is
    filled under the lock)."""
    native, plain, _ = toks
    copy = pickle.loads(pickle.dumps(native))
    assert copy._native is not None and copy._native is not native._native
    texts = [f"{c} {i} <sound> {c[::-1]} {i * 7919}" for i, c in enumerate(CORPUS * 16)]
    want = [plain.encode(t) for t in texts]
    n = 4 * (os.cpu_count() or 4)
    got = [[None] * len(texts) for _ in range(n)]

    def work(k):
        for i in range(len(texts)):
            j = (i + k) % len(texts)
            got[k][j] = copy.encode(texts[j])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(g == want for g in got)


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "bpe.cpp"
    bad.write_text("extern \"C\" int af_bpe_new( { this is not C++\n")
    monkeypatch.setattr(ttok, "CPP_SOURCE", str(bad))
    monkeypatch.setattr(ttok, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed \(1\): .*error: "):
        ttok.BBPETokenizer(*ttok.train_bpe(CORPUS[:1], 300))


def test_sanitizer_smoke_runs_clean(tmp_path):
    srcs = [os.path.join(PKG, "native", "native_smoke.cpp"),
            os.path.join(PKG, "audio", "cpp", "audioio.cpp"),
            os.path.join(PKG, "audio", "cpp", "flac.cpp"),
            os.path.join(PKG, "runtime", "cpp", "bpe.cpp")]
    exe = str(tmp_path / "native_smoke")
    subprocess.run(["g++", "-std=c++17", "-g", "-O1", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=all", *srcs, "-o", exe], check=True,
                   capture_output=True, timeout=300)
    run = subprocess.run([exe], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, ASAN_OPTIONS="detect_leaks=1"))
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "native_smoke: OK"
    assert "runtime error" not in run.stderr and "ERROR: AddressSanitizer" not in run.stderr
