"""Fleet serving (the port's counterpart of ``opsagent_tpu/serving/fleet``):
so far the KV page wire format of replica-to-replica transfers
(``transfer``). The router, the replica registry and client, the fleet
page store, the autoscaler and fault injection are ROADMAP item 13(b)."""
