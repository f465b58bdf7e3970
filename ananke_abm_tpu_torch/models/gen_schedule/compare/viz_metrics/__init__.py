"""Comparison visualizations: ToD curves, duration boxplots, Lorenz/Gini
(matplotlib imported when plotting)."""
