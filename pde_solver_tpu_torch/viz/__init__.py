"""Visualization: plotly-JSON figure construction and animated HTML export."""
