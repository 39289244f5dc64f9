"""Natural-language agent layer: parser, dispatcher, orchestrator, memory."""
