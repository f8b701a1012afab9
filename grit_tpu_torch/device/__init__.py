"""Device layer: quiesce, snapshot format, agentlet and restore hook."""
