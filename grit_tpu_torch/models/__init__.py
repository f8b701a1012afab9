"""Model families ported so far: llama (training and serving) and the
serving engines."""
