"""`ops/build.py` on the CPU, with a stand-in for nvcc that writes its `-o`
file: a build started early is waited for once and installed, and a build
already made is skipped."""
import stat

import pytest

from lumenrenderer_tpu_torch.ops import build

FAKE_NVCC = """#!/bin/sh
echo "$*" >> "{calls}"
while [ "$1" != "-o" ]; do shift; done
sleep 0.2
[ -n "{fail}" ] && case "$3" in *{fail}*) exit 3;; esac
echo built > "$2"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def make(fail=""):
        nvcc = tmp_path / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(calls=tmp_path / "calls",
                                         fail=fail))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
        monkeypatch.setattr(build, "_building", {})
        return tmp_path / "calls"
    return make


def test_a_started_build_is_waited_for_once(fake_nvcc):
    calls = fake_nvcc()
    build.start_builds(["disney_bsdf"])
    build.start_builds(["disney_bsdf"])          # being built: not again
    so = build.library_path("disney_bsdf")
    assert not so.exists()                       # started, not waited for
    results = build.build_libraries(["disney_bsdf", "row_scatter"])
    assert set(results) == {"disney_bsdf", "row_scatter"}
    assert so.read_text() == "built\n"
    lines = calls.read_text().splitlines()
    assert len(lines) == 2
    assert "-fmad=false" in lines[0] and "-fmad=false" not in lines[1]
    assert build.build_libraries(["disney_bsdf"]) == {}    # built: skipped
    assert build._building == {}
    assert len(build.build_libraries(["disney_bsdf"], force=True)) == 1


def test_a_failed_build_raises_and_installs_nothing(fake_nvcc):
    fake_nvcc(fail="disney_bsdf")
    build.start_builds(["disney_bsdf"])
    with pytest.raises(RuntimeError, match="disney_bsdf: nvcc failed"):
        build.build_libraries(["disney_bsdf", "row_scatter"])
    assert not build.library_path("disney_bsdf").exists()
    assert build.library_path("row_scatter").exists()
    assert build._building == {}
