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


@pytest.fixture(scope="module")
def dim11_dataset(tmp_path_factory):
    """(dataset, depth directory) of 8 pairs at 32x64 in the dim11 layout
    (``chip_smoke.py:write_dim11_dataset``: 6-value cam files, the depths in a directory
    of their own), 4 of them in the train split."""
    import chip_smoke

    return chip_smoke.write_dim11_dataset(str(tmp_path_factory.mktemp("dim11")), batch=4,
                                          hw=(32, 64))
