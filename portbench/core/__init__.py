"""The harness: manifest lookup, the request loop, trace reduction, the run."""
