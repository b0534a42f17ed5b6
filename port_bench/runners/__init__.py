"""The general code that runs a traffic mix: one module per `runner` kind
that a traffic file names."""
