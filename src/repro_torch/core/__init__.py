"""Integer codec core: SPC tables, encode update, CDF search, lane coder,
wire container."""
