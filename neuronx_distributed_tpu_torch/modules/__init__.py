"""Model building blocks: norms, projections, attention."""
