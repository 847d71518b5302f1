"""Single-device parameter specs and initialisation."""
