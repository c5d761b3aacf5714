"""The program's side of each model family: ``build(cfg)`` returns the
port's ``(model, train_loss, val_loss)`` for a configuration file, the
module made on the meta device (its parameters are never used: the round
takes the benchmark's flat initial weights)."""
