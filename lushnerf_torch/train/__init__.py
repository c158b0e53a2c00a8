"""Training: losses, the stage schedule, one optimizer step, the `Trainer`
loop and checkpoints."""
