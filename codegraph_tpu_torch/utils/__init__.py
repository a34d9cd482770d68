"""Performance monitor and progress reporting."""
