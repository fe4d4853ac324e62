"""CSV and YAML input/output on the standard library and numpy."""
