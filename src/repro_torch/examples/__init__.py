"""The reference's ``examples/`` on the port, each a module with
``main(argv=None)`` and ``--device`` (the card unless ``cpu``):

    python -m repro_torch.examples.quickstart --device cpu
    python -m repro_torch.examples.compress_images
    python -m repro_torch.examples.compress_latents --steps 600
    python -m repro_torch.examples.train_small_lm --steps 300
"""


def require(ok, what: str) -> None:
    """An example's check: raises ``AssertionError`` when ``ok`` is false
    (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(what)
