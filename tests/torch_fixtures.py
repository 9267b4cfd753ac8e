"""Fixtures shared by the port's test files; a file takes one by importing it."""
import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    """The CLI tests write full-width checkpoints: remove each test's ``tmp_path`` after
    it, so that a whole run's temp tree stays small."""
    yield
    if "tmp_path" in request.node.funcargs:
        shutil.rmtree(request.node.funcargs["tmp_path"], ignore_errors=True)
