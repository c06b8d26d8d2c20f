"""Build the native ingest library once, before xdist's workers collect
``tests/test_native.py``: the JAX package's loader runs ``make`` onto
``native/libbtia_ingest.so`` in place, so workers building or reading it at
once can skip that file's tests. The port's loader writes a file of its own
and renames it into place."""


def pytest_configure():
    from btia_tpu_torch.data import native

    native.available()
