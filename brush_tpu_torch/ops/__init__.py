"""Projection, SH, binning, the dense oracle and the record pipeline."""
