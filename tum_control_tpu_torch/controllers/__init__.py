"""Controllers (this slice: the nominal NMPC)."""
