"""Dry-run analysis: traced op counts, collective bytes, the H100
roofline and the report tables."""
