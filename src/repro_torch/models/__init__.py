"""Models of the paper: GNMT (DS2 follows in a later slice)."""
