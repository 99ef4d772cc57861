"""Per-cell drivers: set-up, one unit, the check, the control."""
