"""Multi-device drivers on ``torch.distributed``: one rank a device.

``dist`` holds the process group, the (data, hash) grid and the sharded
pw driver ``run_pw_dist``; ``sharded`` the hash-sharded overlap steps;
``cns_dist`` the template-sharded ``run_cns_dist``; ``dryrun`` a multi-rank
dry run of all three.
"""
