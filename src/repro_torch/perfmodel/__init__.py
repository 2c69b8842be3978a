"""Machine models for the analytic track (Track A) of the reproduction."""
