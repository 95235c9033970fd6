"""A fixture that gives each test module of the port a trim cache of its own.

`HeliEnv.trim_result` reads and writes a disk cache keyed by the model, the
mean wind and the trim condition, not by the solver's code. A test module
that imports `fresh_trim_cache` points `HELIGYM_TPU_TORCH_CACHE` at an empty
directory for its whole run, so every trim it reaches is solved by the code
under test (once per condition; the module's later resets hit its own
cache), never read from a cache that an earlier version wrote.
"""
import pytest


@pytest.fixture(scope="module", autouse=True)
def fresh_trim_cache(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HELIGYM_TPU_TORCH_CACHE", str(tmp_path_factory.mktemp("trim_cache")))
        yield
