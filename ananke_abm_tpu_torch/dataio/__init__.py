"""Activities CSV -> purpose-id grids, and grid splits (numpy host code)."""
