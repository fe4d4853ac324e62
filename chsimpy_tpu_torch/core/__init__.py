"""The single-device solver: state, step and host loop."""
