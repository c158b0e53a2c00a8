"""Training: losses, the stage schedule, and one optimizer step."""
