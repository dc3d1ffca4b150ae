"""Each test's ``tmp_path`` emptied once the test is over, for the port's
CPU test files that write InceptionV3 checkpoints.

A fine-tune's save directory holds its weights two or three times over
(``train_state.npz`` ~180 MB, ``loss_bset.npz`` and ``last_bset.npz``
~90 MB each), and a test that compares two runs writes it twice: left in
place, the suite's port files alone leave about 7 GB behind per run, and
pytest keeps the last three runs' directories. A test file takes the
fixture by importing it::

    from torch_tmp import drop_tmp_path  # noqa: F401

The directory goes whether the test passed or failed.
"""

import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_tmp_path(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)
