"""The native library is rebuilt when its sources or flags change (not
when only mtimes move) and is published atomically, so concurrent
builders never load a partial file."""

import os
import subprocess
import threading
import time

import pytest

from emsar_jax.ingest import native


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """Sources in tmp_path and a fake compiler that records its calls."""
    src = tmp_path / "a.cc"
    src.write_text("int f() { return 1; }\n")
    monkeypatch.setattr(native, "_SRCS", [str(src)])
    monkeypatch.setattr(native, "_SO_DIR", str(tmp_path / "_build"))
    calls = []

    def fake_run(cmd, check, capture_output):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as fh:
            for _ in range(64):  # written in pieces, like a real linker
                fh.write(b"x" * 1024)
                time.sleep(0.0005)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native.subprocess, "run", fake_run)
    return src, calls


def test_rebuild_keyed_by_source_hash(fake_build, monkeypatch):
    src, calls = fake_build
    first = native._build()
    assert first is not None and os.path.exists(first) and len(calls) == 1
    assert native._build() == first and len(calls) == 1
    future = time.time() + 3600
    os.utime(src, (future, future))  # newer mtime, same bytes
    assert native._build() == first and len(calls) == 1
    src.write_text("int f() { return 2; }\n")
    second = native._build()
    assert second != first and len(calls) == 2
    monkeypatch.setattr(native, "_CXXFLAGS", native._CXXFLAGS + ["-g"])
    third = native._build()
    assert third not in (first, second) and len(calls) == 3


def test_rebuild_deletes_stale_libraries(fake_build):
    src, _ = fake_build
    first = native._build()
    unrelated = os.path.join(native._SO_DIR, "other.so")
    open(unrelated, "wb").close()
    src.write_text("int f() { return 3; }\n")
    second = native._build()
    assert sorted(os.listdir(native._SO_DIR)) == sorted(
        [os.path.basename(second), "other.so"])
    assert not os.path.exists(first)


def test_concurrent_builders_publish_a_complete_library(fake_build):
    _, calls = fake_build
    results, errors = [], []

    def worker():
        try:
            results.append(native._build())
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(results)) == 1
    so = results[0]
    assert os.path.getsize(so) == 64 * 1024
    assert not [f for f in os.listdir(os.path.dirname(so))
                if f.endswith(".tmp")]


def test_failed_build_returns_none(fake_build, monkeypatch):
    def failing(cmd, check, capture_output):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        raise subprocess.CalledProcessError(1, cmd, stderr=b"zlib.h missing")

    monkeypatch.setattr(native.subprocess, "run", failing)
    assert native._build() is None
    assert not [f for f in os.listdir(native._SO_DIR) if f.endswith(".tmp")]


def test_library_builds_from_committed_sources():
    """The real build: the library name carries the sources' hash."""
    assert native.available()
    assert os.path.exists(native._so_path())
