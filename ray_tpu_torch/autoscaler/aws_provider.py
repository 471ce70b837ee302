"""AWS-style cloud node provider.

Reference: python/ray/autoscaler/_private/aws/node_provider.py — the
EC2 plugin behind the NodeProvider surface: launch via
``run_instances``, discover via ``describe_instances`` with tag
filters, tag via ``create_tags``, reap via ``terminate_instances``.

The EC2 client is injected (boto3-shaped): pass ``boto3.client("ec2")``
on a real account, or :class:`FakeEC2Client` — an in-memory mock with
the create/terminate/tag/filter semantics of the real API — which the
test suite drives the full autoscaler reconcile loop against (this
image has no boto3 and zero egress; the seam is what parity requires).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider


class FakeEC2Client:
    """boto3-shaped EC2 mock: instances with states, tags, private IPs,
    and describe-filters. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Dict[str, Any]] = {}
        self._ip_octet = 10

    def run_instances(self, MaxCount: int = 1, MinCount: int = 1,
                      TagSpecifications: Optional[List] = None,
                      **kwargs) -> Dict:
        tags = []
        for spec in TagSpecifications or []:
            if spec.get("ResourceType") == "instance":
                tags.extend(spec.get("Tags", []))
        out = []
        with self._lock:
            for _ in range(MaxCount):
                iid = "i-" + uuid.uuid4().hex[:17]
                self._ip_octet += 1
                inst = {
                    "InstanceId": iid,
                    "State": {"Name": "running"},
                    "PrivateIpAddress": f"10.0.0.{self._ip_octet}",
                    "Tags": [dict(t) for t in tags],
                    "InstanceType": kwargs.get("InstanceType", ""),
                }
                self._instances[iid] = inst
                out.append(inst)
        return {"Instances": out}

    def terminate_instances(self, InstanceIds: List[str]) -> Dict:
        with self._lock:
            for iid in InstanceIds:
                inst = self._instances.get(iid)
                if inst is not None:
                    inst["State"] = {"Name": "terminated"}
        return {}

    def create_tags(self, Resources: List[str], Tags: List[Dict]) -> Dict:
        with self._lock:
            for iid in Resources:
                inst = self._instances.get(iid)
                if inst is None:
                    continue
                for new in Tags:
                    for t in inst["Tags"]:
                        if t["Key"] == new["Key"]:
                            t["Value"] = new["Value"]
                            break
                    else:
                        inst["Tags"].append(dict(new))
        return {}

    def describe_instances(self, Filters: Optional[List[Dict]] = None,
                           **_) -> Dict:
        def matches(inst) -> bool:
            for f in Filters or []:
                name, values = f["Name"], f["Values"]
                if name == "instance-state-name":
                    if inst["State"]["Name"] not in values:
                        return False
                elif name.startswith("tag:"):
                    key = name[4:]
                    tag = {t["Key"]: t["Value"] for t in inst["Tags"]}
                    if tag.get(key) not in values:
                        return False
                else:
                    return False
            return True

        with self._lock:
            found = [dict(i) for i in self._instances.values()
                     if matches(i)]
        return {"Reservations": [{"Instances": found}]} if found else {
            "Reservations": []}


class AwsNodeProvider(NodeProvider):
    """EC2-backed NodeProvider. provider_config keys:

      region            informational
      _client           injected boto3-shaped client (tests/MinIO-style
                        stacks); absent -> boto3.client("ec2", region)
    """

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str):
        super().__init__(provider_config, cluster_name)
        client = provider_config.get("_client")
        if client is None:
            try:
                import boto3  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "aws provider needs boto3 (or inject a "
                    "boto3-shaped client via provider._client)") from e
            client = boto3.client(
                "ec2", region_name=provider_config.get("region"))
        self.ec2 = client

    # -------------------------------------------------------------- helpers
    def _cluster_filter(self) -> List[Dict]:
        return [
            {"Name": "instance-state-name", "Values": ["pending",
                                                       "running"]},
            {"Name": "tag:ray-cluster-name",
             "Values": [self.cluster_name]},
        ]

    def _describe(self, extra: Optional[List[Dict]] = None) -> List[Dict]:
        resp = self.ec2.describe_instances(
            Filters=self._cluster_filter() + (extra or []))
        out = []
        for res in resp.get("Reservations", []):
            out.extend(res.get("Instances", []))
        return out

    def _get(self, node_id: str) -> Optional[Dict]:
        for inst in self._describe():
            if inst["InstanceId"] == node_id:
                return inst
        return None

    # ------------------------------------------------------------- surface
    def non_terminated_nodes(self, tag_filters: Dict[str, str]
                             ) -> List[str]:
        extra = [{"Name": f"tag:{k}", "Values": [v]}
                 for k, v in tag_filters.items()]
        return [i["InstanceId"] for i in self._describe(extra)]

    def is_running(self, node_id: str) -> bool:
        inst = self._get(node_id)
        return bool(inst) and inst["State"]["Name"] == "running"

    def node_tags(self, node_id: str) -> Dict[str, str]:
        inst = self._get(node_id)
        if inst is None:
            return {}
        return {t["Key"]: t["Value"] for t in inst["Tags"]}

    def set_node_tags(self, node_id: str, tags: Dict[str, str]) -> None:
        self.ec2.create_tags(
            Resources=[node_id],
            Tags=[{"Key": k, "Value": v} for k, v in tags.items()])

    def internal_ip(self, node_id: str) -> str:
        inst = self._get(node_id)
        return inst.get("PrivateIpAddress", "") if inst else ""

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        all_tags = dict(tags)
        all_tags["ray-cluster-name"] = self.cluster_name
        self.ec2.run_instances(
            MaxCount=count, MinCount=count,
            InstanceType=node_config.get("InstanceType", ""),
            TagSpecifications=[{
                "ResourceType": "instance",
                "Tags": [{"Key": k, "Value": v}
                         for k, v in all_tags.items()],
            }])

    def terminate_node(self, node_id: str) -> None:
        self.ec2.terminate_instances(InstanceIds=[node_id])
