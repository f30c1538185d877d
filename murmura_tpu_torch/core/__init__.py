"""Round program and orchestrator."""
