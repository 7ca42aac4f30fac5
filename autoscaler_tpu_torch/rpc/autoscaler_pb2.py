# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: autoscaler.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10\x61utoscaler.proto\x12\x0e\x61utoscaler_tpu\"c\n\nPackedPods\x12\x10\n\x08requests\x18\x01 \x01(\x0c\x12\x10\n\x08num_pods\x18\x02 \x01(\x05\x12\x15\n\rnum_resources\x18\x03 \x01(\x05\x12\x1a\n\x12\x65xtended_resources\x18\x04 \x03(\t\"\xa0\x01\n\x0f\x45stimateRequest\x12(\n\x04pods\x18\x01 \x01(\x0b\x32\x1a.autoscaler_tpu.PackedPods\x12\x11\n\tpod_masks\x18\x02 \x01(\x0c\x12\x17\n\x0ftemplate_allocs\x18\x03 \x01(\x0c\x12\x11\n\tgroup_ids\x18\x04 \x03(\t\x12\x11\n\tnode_caps\x18\x05 \x01(\x0c\x12\x11\n\tmax_nodes\x18\x06 \x01(\x05\":\n\x10\x45stimateResponse\x12\x13\n\x0bnode_counts\x18\x01 \x01(\x0c\x12\x11\n\tscheduled\x18\x02 \x01(\x0c\"\xd4\x01\n\rSpreadContext\x12\r\n\x05sp_of\x18\x01 \x01(\x0c\x12\x10\n\x08sp_match\x18\x02 \x01(\x0c\x12\x10\n\x08node_dom\x18\x03 \x01(\x0c\x12\x0f\n\x07sp_elig\x18\x04 \x01(\x0c\x12\x11\n\tdom_valid\x18\x05 \x01(\x0c\x12\x15\n\rstatic_counts\x18\x06 \x01(\x0c\x12\x0c\n\x04skew\x18\x07 \x01(\x0c\x12\x0f\n\x07min_dom\x18\x08 \x01(\x0c\x12\x0e\n\x06\x64omnum\x18\t \x01(\x0c\x12\x11\n\tnum_terms\x18\n \x01(\x05\x12\x13\n\x0bnum_domains\x18\x0b \x01(\x05\"\xc9\x01\n\x12TryScheduleRequest\x12(\n\x04pods\x18\x01 \x01(\x0b\x32\x1a.autoscaler_tpu.PackedPods\x12\x11\n\tnode_free\x18\x02 \x01(\x0c\x12\x12\n\nsched_mask\x18\x03 \x01(\x0c\x12\x11\n\tpod_slots\x18\x04 \x01(\x0c\x12\r\n\x05hints\x18\x05 \x01(\x0c\x12\x11\n\tnum_nodes\x18\x06 \x01(\x05\x12-\n\x06spread\x18\x07 \x01(\x0b\x32\x1d.autoscaler_tpu.SpreadContext\"3\n\x13TryScheduleResponse\x12\x0e\n\x06placed\x18\x01 \x01(\x0c\x12\x0c\n\x04\x64\x65st\x18\x02 \x01(\x0c\"\xe7\x01\n\x18\x46indNodesToRemoveRequest\x12(\n\x04pods\x18\x01 \x01(\x0b\x32\x1a.autoscaler_tpu.PackedPods\x12\x12\n\nnode_alloc\x18\x02 \x01(\x0c\x12\x11\n\tnode_used\x18\x03 \x01(\x0c\x12\x12\n\nsched_mask\x18\x04 \x01(\x0c\x12\x17\n\x0f\x63\x61ndidate_nodes\x18\x05 \x01(\x0c\x12\x11\n\tpod_slots\x18\x06 \x01(\x0c\x12\x0f\n\x07\x62locked\x18\x07 \x01(\x0c\x12\x11\n\tnum_nodes\x18\x08 \x01(\x05\x12\x16\n\x0eslots_per_node\x18\t \x01(\x05\"C\n\x19\x46indNodesToRemoveResponse\x12\x10\n\x08\x66\x65\x61sible\x18\x01 \x01(\x0c\x12\x14\n\x0c\x64\x65stinations\x18\x02 \x01(\x0c\"T\n\x06Option\x12\x10\n\x08group_id\x18\x01 \x01(\t\x12\x12\n\nnode_count\x18\x02 \x01(\x05\x12\x10\n\x08pod_keys\x18\x03 \x03(\t\x12\x12\n\nscore_hint\x18\x04 \x01(\x01\"=\n\x12\x42\x65stOptionsRequest\x12\'\n\x07options\x18\x01 \x03(\x0b\x32\x16.autoscaler_tpu.Option\";\n\x13\x42\x65stOptionsResponse\x12$\n\x04\x62\x65st\x18\x01 \x03(\x0b\x32\x16.autoscaler_tpu.Option\"\x07\n\x05\x45mpty\"\x8b\x01\n\rNodeGroupSpec\x12\n\n\x02id\x18\x01 \x01(\t\x12\x10\n\x08min_size\x18\x02 \x01(\x05\x12\x10\n\x08max_size\x18\x03 \x01(\x05\x12\x13\n\x0btarget_size\x18\x04 \x01(\x05\x12\x12\n\x05\x65xist\x18\x05 \x01(\x08H\x00\x88\x01\x01\x12\x17\n\x0f\x61utoprovisioned\x18\x06 \x01(\x08\x42\x08\n\x06_exist\"C\n\x12NodeGroupsResponse\x12-\n\x06groups\x18\x01 \x03(\x0b\x32\x1d.autoscaler_tpu.NodeGroupSpec\"A\n\x17NodeGroupForNodeRequest\x12\x11\n\tnode_name\x18\x01 \x01(\t\x12\x13\n\x0bprovider_id\x18\x02 \x01(\t\",\n\x18NodeGroupForNodeResponse\x12\x10\n\x08group_id\x18\x01 \x01(\t\"6\n\x13IncreaseSizeRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\x12\r\n\x05\x64\x65lta\x18\x02 \x01(\x05\":\n\x12\x44\x65leteNodesRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\x12\x12\n\nnode_names\x18\x02 \x03(\t\"<\n\x19\x44\x65\x63reaseTargetSizeRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\x12\r\n\x05\x64\x65lta\x18\x02 \x01(\x05\"6\n\x08TaintMsg\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\"#\n\x0fTemplateRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\"\xbe\x01\n\x10TemplateResponse\x12\x13\n\x0b\x61llocatable\x18\x01 \x01(\x0c\x12<\n\x06labels\x18\x02 \x03(\x0b\x32,.autoscaler_tpu.TemplateResponse.LabelsEntry\x12(\n\x06taints\x18\x03 \x03(\x0b\x32\x18.autoscaler_tpu.TaintMsg\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"T\n\x0bInstanceMsg\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t\x12\x13\n\x0b\x65rror_class\x18\x03 \x01(\t\x12\x15\n\rerror_message\x18\x04 \x01(\t\"$\n\x10InstancesRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\"C\n\x11InstancesResponse\x12.\n\tinstances\x18\x01 \x03(\x0b\x32\x1b.autoscaler_tpu.InstanceMsg\"\xdc\x01\n\x10NodePriceRequest\x12\x11\n\tnode_name\x18\x01 \x01(\t\x12\x13\n\x0bprovider_id\x18\x02 \x01(\t\x12<\n\x06labels\x18\x03 \x03(\x0b\x32,.autoscaler_tpu.NodePriceRequest.LabelsEntry\x12\x13\n\x0b\x61llocatable\x18\x04 \x01(\x0c\x12\x0f\n\x07start_s\x18\x05 \x01(\x01\x12\r\n\x05\x65nd_s\x18\x06 \x01(\x01\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"U\n\x0fPodPriceRequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x10\n\x08requests\x18\x02 \x01(\x0c\x12\x0f\n\x07start_s\x18\x03 \x01(\x01\x12\r\n\x05\x65nd_s\x18\x04 \x01(\x01\"-\n\rPriceResponse\x12\r\n\x05price\x18\x01 \x01(\x01\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"!\n\x10GpuLabelResponse\x12\r\n\x05label\x18\x01 \x01(\t\"!\n\x10GpuTypesResponse\x12\r\n\x05types\x18\x01 \x03(\t\"\x92\x02\n\x16ResourceLimitsResponse\x12I\n\nmin_limits\x18\x01 \x03(\x0b\x32\x35.autoscaler_tpu.ResourceLimitsResponse.MinLimitsEntry\x12I\n\nmax_limits\x18\x02 \x03(\x0b\x32\x35.autoscaler_tpu.ResourceLimitsResponse.MaxLimitsEntry\x1a\x30\n\x0eMinLimitsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\x1a\x30\n\x0eMaxLimitsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\xba\x02\n\x16NodeGroupCreateRequest\x12+\n\x04spec\x18\x01 \x01(\x0b\x32\x1d.autoscaler_tpu.NodeGroupSpec\x12\x1c\n\x14template_allocatable\x18\x02 \x01(\x0c\x12S\n\x0ftemplate_labels\x18\x03 \x03(\x0b\x32:.autoscaler_tpu.NodeGroupCreateRequest.TemplateLabelsEntry\x12\x31\n\x0ftemplate_taints\x18\x04 \x03(\x0b\x32\x18.autoscaler_tpu.TaintMsg\x12\x16\n\x0eprice_per_hour\x18\x05 \x01(\x01\x1a\x35\n\x13TemplateLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"I\n\x17NodeGroupCreateResponse\x12.\n\x07\x63reated\x18\x01 \x01(\x0b\x32\x1d.autoscaler_tpu.NodeGroupSpec\"&\n\x12NodeGroupIdRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\"\x91\x02\n\x13GroupOptionsRequest\x12\x10\n\x08group_id\x18\x01 \x01(\t\x12\x30\n(default_scale_down_utilization_threshold\x18\x02 \x01(\x01\x12\x34\n,default_scale_down_gpu_utilization_threshold\x18\x03 \x01(\x01\x12*\n\"default_scale_down_unneeded_time_s\x18\x04 \x01(\x01\x12)\n!default_scale_down_unready_time_s\x18\x05 \x01(\x01\x12)\n!default_max_node_provision_time_s\x18\x06 \x01(\x01\"\xe5\x01\n\x14GroupOptionsResponse\x12\x0b\n\x03has\x18\x01 \x01(\x08\x12(\n scale_down_utilization_threshold\x18\x02 \x01(\x01\x12,\n$scale_down_gpu_utilization_threshold\x18\x03 \x01(\x01\x12\"\n\x1ascale_down_unneeded_time_s\x18\x04 \x01(\x01\x12!\n\x19scale_down_unready_time_s\x18\x05 \x01(\x01\x12!\n\x19max_node_provision_time_s\x18\x06 \x01(\x01\x32\xf8\x02\n\rTpuSimulation\x12M\n\x08\x45stimate\x12\x1f.autoscaler_tpu.EstimateRequest\x1a .autoscaler_tpu.EstimateResponse\x12V\n\x0bTrySchedule\x12\".autoscaler_tpu.TryScheduleRequest\x1a#.autoscaler_tpu.TryScheduleResponse\x12h\n\x11\x46indNodesToRemove\x12(.autoscaler_tpu.FindNodesToRemoveRequest\x1a).autoscaler_tpu.FindNodesToRemoveResponse\x12V\n\x0b\x42\x65stOptions\x12\".autoscaler_tpu.BestOptionsRequest\x1a#.autoscaler_tpu.BestOptionsResponse2\xf5\n\n\x14\x43loudProviderService\x12G\n\nNodeGroups\x12\x15.autoscaler_tpu.Empty\x1a\".autoscaler_tpu.NodeGroupsResponse\x12\x65\n\x10NodeGroupForNode\x12\'.autoscaler_tpu.NodeGroupForNodeRequest\x1a(.autoscaler_tpu.NodeGroupForNodeResponse\x12J\n\x0cIncreaseSize\x12#.autoscaler_tpu.IncreaseSizeRequest\x1a\x15.autoscaler_tpu.Empty\x12H\n\x0b\x44\x65leteNodes\x12\".autoscaler_tpu.DeleteNodesRequest\x1a\x15.autoscaler_tpu.Empty\x12V\n\x12\x44\x65\x63reaseTargetSize\x12).autoscaler_tpu.DecreaseTargetSizeRequest\x1a\x15.autoscaler_tpu.Empty\x12U\n\x10TemplateNodeInfo\x12\x1f.autoscaler_tpu.TemplateRequest\x1a .autoscaler_tpu.TemplateResponse\x12P\n\tInstances\x12 .autoscaler_tpu.InstancesRequest\x1a!.autoscaler_tpu.InstancesResponse\x12\x37\n\x07Refresh\x12\x15.autoscaler_tpu.Empty\x1a\x15.autoscaler_tpu.Empty\x12S\n\x10PricingNodePrice\x12 .autoscaler_tpu.NodePriceRequest\x1a\x1d.autoscaler_tpu.PriceResponse\x12Q\n\x0fPricingPodPrice\x12\x1f.autoscaler_tpu.PodPriceRequest\x1a\x1d.autoscaler_tpu.PriceResponse\x12\x43\n\x08GPULabel\x12\x15.autoscaler_tpu.Empty\x1a .autoscaler_tpu.GpuLabelResponse\x12O\n\x14GetAvailableGPUTypes\x12\x15.autoscaler_tpu.Empty\x1a .autoscaler_tpu.GpuTypesResponse\x12R\n\x11GetResourceLimits\x12\x15.autoscaler_tpu.Empty\x1a&.autoscaler_tpu.ResourceLimitsResponse\x12\x62\n\x0fNodeGroupCreate\x12&.autoscaler_tpu.NodeGroupCreateRequest\x1a\'.autoscaler_tpu.NodeGroupCreateResponse\x12L\n\x0fNodeGroupDelete\x12\".autoscaler_tpu.NodeGroupIdRequest\x1a\x15.autoscaler_tpu.Empty\x12`\n\x13NodeGroupGetOptions\x12#.autoscaler_tpu.GroupOptionsRequest\x1a$.autoscaler_tpu.GroupOptionsResponse\x12\x37\n\x07\x43leanup\x12\x15.autoscaler_tpu.Empty\x1a\x15.autoscaler_tpu.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'autoscaler_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TEMPLATERESPONSE_LABELSENTRY._options = None
  _TEMPLATERESPONSE_LABELSENTRY._serialized_options = b'8\001'
  _NODEPRICEREQUEST_LABELSENTRY._options = None
  _NODEPRICEREQUEST_LABELSENTRY._serialized_options = b'8\001'
  _RESOURCELIMITSRESPONSE_MINLIMITSENTRY._options = None
  _RESOURCELIMITSRESPONSE_MINLIMITSENTRY._serialized_options = b'8\001'
  _RESOURCELIMITSRESPONSE_MAXLIMITSENTRY._options = None
  _RESOURCELIMITSRESPONSE_MAXLIMITSENTRY._serialized_options = b'8\001'
  _NODEGROUPCREATEREQUEST_TEMPLATELABELSENTRY._options = None
  _NODEGROUPCREATEREQUEST_TEMPLATELABELSENTRY._serialized_options = b'8\001'
  _PACKEDPODS._serialized_start=36
  _PACKEDPODS._serialized_end=135
  _ESTIMATEREQUEST._serialized_start=138
  _ESTIMATEREQUEST._serialized_end=298
  _ESTIMATERESPONSE._serialized_start=300
  _ESTIMATERESPONSE._serialized_end=358
  _SPREADCONTEXT._serialized_start=361
  _SPREADCONTEXT._serialized_end=573
  _TRYSCHEDULEREQUEST._serialized_start=576
  _TRYSCHEDULEREQUEST._serialized_end=777
  _TRYSCHEDULERESPONSE._serialized_start=779
  _TRYSCHEDULERESPONSE._serialized_end=830
  _FINDNODESTOREMOVEREQUEST._serialized_start=833
  _FINDNODESTOREMOVEREQUEST._serialized_end=1064
  _FINDNODESTOREMOVERESPONSE._serialized_start=1066
  _FINDNODESTOREMOVERESPONSE._serialized_end=1133
  _OPTION._serialized_start=1135
  _OPTION._serialized_end=1219
  _BESTOPTIONSREQUEST._serialized_start=1221
  _BESTOPTIONSREQUEST._serialized_end=1282
  _BESTOPTIONSRESPONSE._serialized_start=1284
  _BESTOPTIONSRESPONSE._serialized_end=1343
  _EMPTY._serialized_start=1345
  _EMPTY._serialized_end=1352
  _NODEGROUPSPEC._serialized_start=1355
  _NODEGROUPSPEC._serialized_end=1494
  _NODEGROUPSRESPONSE._serialized_start=1496
  _NODEGROUPSRESPONSE._serialized_end=1563
  _NODEGROUPFORNODEREQUEST._serialized_start=1565
  _NODEGROUPFORNODEREQUEST._serialized_end=1630
  _NODEGROUPFORNODERESPONSE._serialized_start=1632
  _NODEGROUPFORNODERESPONSE._serialized_end=1676
  _INCREASESIZEREQUEST._serialized_start=1678
  _INCREASESIZEREQUEST._serialized_end=1732
  _DELETENODESREQUEST._serialized_start=1734
  _DELETENODESREQUEST._serialized_end=1792
  _DECREASETARGETSIZEREQUEST._serialized_start=1794
  _DECREASETARGETSIZEREQUEST._serialized_end=1854
  _TAINTMSG._serialized_start=1856
  _TAINTMSG._serialized_end=1910
  _TEMPLATEREQUEST._serialized_start=1912
  _TEMPLATEREQUEST._serialized_end=1947
  _TEMPLATERESPONSE._serialized_start=1950
  _TEMPLATERESPONSE._serialized_end=2140
  _TEMPLATERESPONSE_LABELSENTRY._serialized_start=2095
  _TEMPLATERESPONSE_LABELSENTRY._serialized_end=2140
  _INSTANCEMSG._serialized_start=2142
  _INSTANCEMSG._serialized_end=2226
  _INSTANCESREQUEST._serialized_start=2228
  _INSTANCESREQUEST._serialized_end=2264
  _INSTANCESRESPONSE._serialized_start=2266
  _INSTANCESRESPONSE._serialized_end=2333
  _NODEPRICEREQUEST._serialized_start=2336
  _NODEPRICEREQUEST._serialized_end=2556
  _NODEPRICEREQUEST_LABELSENTRY._serialized_start=2095
  _NODEPRICEREQUEST_LABELSENTRY._serialized_end=2140
  _PODPRICEREQUEST._serialized_start=2558
  _PODPRICEREQUEST._serialized_end=2643
  _PRICERESPONSE._serialized_start=2645
  _PRICERESPONSE._serialized_end=2690
  _GPULABELRESPONSE._serialized_start=2692
  _GPULABELRESPONSE._serialized_end=2725
  _GPUTYPESRESPONSE._serialized_start=2727
  _GPUTYPESRESPONSE._serialized_end=2760
  _RESOURCELIMITSRESPONSE._serialized_start=2763
  _RESOURCELIMITSRESPONSE._serialized_end=3037
  _RESOURCELIMITSRESPONSE_MINLIMITSENTRY._serialized_start=2939
  _RESOURCELIMITSRESPONSE_MINLIMITSENTRY._serialized_end=2987
  _RESOURCELIMITSRESPONSE_MAXLIMITSENTRY._serialized_start=2989
  _RESOURCELIMITSRESPONSE_MAXLIMITSENTRY._serialized_end=3037
  _NODEGROUPCREATEREQUEST._serialized_start=3040
  _NODEGROUPCREATEREQUEST._serialized_end=3354
  _NODEGROUPCREATEREQUEST_TEMPLATELABELSENTRY._serialized_start=3301
  _NODEGROUPCREATEREQUEST_TEMPLATELABELSENTRY._serialized_end=3354
  _NODEGROUPCREATERESPONSE._serialized_start=3356
  _NODEGROUPCREATERESPONSE._serialized_end=3429
  _NODEGROUPIDREQUEST._serialized_start=3431
  _NODEGROUPIDREQUEST._serialized_end=3469
  _GROUPOPTIONSREQUEST._serialized_start=3472
  _GROUPOPTIONSREQUEST._serialized_end=3745
  _GROUPOPTIONSRESPONSE._serialized_start=3748
  _GROUPOPTIONSRESPONSE._serialized_end=3977
  _TPUSIMULATION._serialized_start=3980
  _TPUSIMULATION._serialized_end=4356
  _CLOUDPROVIDERSERVICE._serialized_start=4359
  _CLOUDPROVIDERSERVICE._serialized_end=5756
# @@protoc_insertion_point(module_scope)
