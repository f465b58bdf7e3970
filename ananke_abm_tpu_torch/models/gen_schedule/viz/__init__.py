"""Population visualization (matplotlib, Agg backend, imported lazily)."""
