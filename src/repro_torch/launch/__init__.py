"""The launcher: process groups and meshes (``mesh``), the logical-axis
sharding rules and the hooks the launcher installs (``sharding``), and the
runnable LM training loop and command line (``train``)."""
