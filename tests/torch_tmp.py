"""Disk hygiene for the port's tests: a test module's temporary files go
once its last test has run.

pytest keeps the base temporary directories of its last three runs, and the
port's tests write checkpoints, exported programs, worker inputs and the
weights of full-width models there: several GiB a run. A test module that
imports `drop_module_tmp` removes, when its tests are done, every entry that
its tests and fixtures made under the run's base temporary directory. It
keeps them when one of the run's tests failed meanwhile, so that a failure's
files stay to be looked at.
"""
import shutil

import pytest


@pytest.fixture(scope="module", autouse=True)
def drop_module_tmp(request, tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed != failed:
        return
    for path in set(base.iterdir()) - before:
        if path.is_symlink() or not path.is_dir():
            path.unlink(missing_ok=True)
        else:
            shutil.rmtree(path, ignore_errors=True)
