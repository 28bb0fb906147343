"""The benchmark's own tests.  Tests that need a CUDA card carry the
`card` marker and skip, with the reason, where there is none; the
decision is made inside each test, never at import."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs on the chip)")
