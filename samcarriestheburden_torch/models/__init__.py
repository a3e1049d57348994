"""SAM modules with the reference's parameter names."""
