"""Provisioning layer (L0) — TPU-VM pod slices instead of CloudFormation.

The reference's `deeplearning.template` (SURVEY.md §3.1) declared a VPC,
security groups, IAM, a master EC2 instance, a worker AutoScalingGroup, EFS
mounts, and a WaitCondition that gated "cluster ready". A TPU pod slice
collapses nearly all of that: one API call creates N hosts wired by ICI with
shared topology metadata. What remains in-tree is the stack lifecycle
(`create / delete / status / list`), a local state store (the CFN stack table
equivalent), a readiness gate (the WaitCondition equivalent), and a dry-run
provisioner so every path is testable without GCP (the reference's
`validate-template` role).
"""

from .stack import HostRecord, StackState, StackStatus, StackStore
from .provisioner import (
    DryRunProvisioner,
    GcpProvisioner,
    Provisioner,
    ProvisionError,
    create_stack,
    delete_stack,
    get_provisioner,
    resize_stack,
)
from .topology import SliceTopology, slice_topology

__all__ = [
    "DryRunProvisioner",
    "GcpProvisioner",
    "HostRecord",
    "Provisioner",
    "ProvisionError",
    "SliceTopology",
    "StackState",
    "StackStatus",
    "StackStore",
    "create_stack",
    "delete_stack",
    "get_provisioner",
    "resize_stack",
    "slice_topology",
]
