"""Train-state layout and state conversion."""
