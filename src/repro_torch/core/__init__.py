"""Integer codec core: SPC tables, encode update, CDF search, lane coder,
wire container, and the scalar oracles (``golden``, ``python_baseline``)."""
