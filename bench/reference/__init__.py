"""Plain PyTorch references of the configurations the benchmark runs, one
module a family of architectures, named by a configuration file's
``reference`` key."""
