"""Every remaining script imports cleanly (its names resolve against the
library as it is now) without running: scripts keep their work under
``if __name__ == "__main__"``."""

import glob
import importlib.util
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(ROOT, "scripts", "*.py")))


def test_scripts_exist():
    assert len(SCRIPTS) >= 5


@pytest.mark.parametrize("path", SCRIPTS, ids=os.path.basename)
def test_script_imports_without_running(path, monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    monkeypatch.setattr(sys, "argv", [path])
    name = "script_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.__name__ == name
