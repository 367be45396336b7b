"""Launch layer of the port: meshes and shardings (`mesh`), input shapes
(`shapes`), the train and serving steps (`train`, `serve`), the dry run
(`dryrun`, `comm_analysis`) and the roofline reports (`roofline`)."""
