"""Flow networks of the port: FlowNet2 (and TinyFlowNet), LiteFlowNetCorr,
TCEA fusion."""
