"""The harness's own machinery: discovery of cells by name, the run's
environment, weights, timing, traces and the result line."""
