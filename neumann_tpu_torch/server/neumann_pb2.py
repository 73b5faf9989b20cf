# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: neumann.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rneumann.proto\x12\x07neumann\"1\n\x0cQueryRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\x12\n\nrequest_id\x18\x02 \x01(\t\"\x13\n\x03Row\x12\x0c\n\x04json\x18\x01 \x01(\t\"!\n\x03Hit\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\"\x98\x01\n\rQueryResponse\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x1a\n\x04rows\x18\x03 \x03(\x0b\x32\x0c.neumann.Row\x12\x1a\n\x04hits\x18\x04 \x03(\x0b\x32\x0c.neumann.Hit\x12\r\n\x05\x63ount\x18\x05 \x01(\x03\x12\x12\n\nvalue_json\x18\x06 \x01(\t\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"6\n\x0c\x42\x61tchRequest\x12&\n\x07queries\x18\x01 \x03(\x0b\x32\x15.neumann.QueryRequest\"8\n\rBatchResponse\x12\'\n\x07results\x18\x01 \x03(\x0b\x32\x16.neumann.QueryResponse\"D\n\x10PaginatedRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\x11\n\tpage_size\x18\x02 \x01(\x05\x12\x0e\n\x06\x63ursor\x18\x03 \x01(\t\"S\n\x11PaginatedResponse\x12\x1a\n\x04rows\x18\x01 \x03(\x0b\x32\x0c.neumann.Row\x12\x13\n\x0bnext_cursor\x18\x02 \x01(\t\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"$\n\x12\x43loseCursorRequest\x12\x0e\n\x06\x63ursor\x18\x01 \x01(\t\"%\n\x13\x43loseCursorResponse\x12\x0e\n\x06\x63losed\x18\x01 \x01(\x08\"\x0f\n\rHealthRequest\"N\n\x0eHealthResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x0f\n\x07\x65ntries\x18\x03 \x01(\x03\x12\x0e\n\x06\x64\x65vice\x18\x04 \x01(\t\"9\n\x05Point\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x14\n\x0cpayload_json\x18\x03 \x01(\t\"I\n\x13UpsertPointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x1e\n\x06points\x18\x02 \x03(\x0b\x32\x0e.neumann.Point\"7\n\x14UpsertPointsResponse\x12\x10\n\x08upserted\x18\x01 \x01(\x03\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"3\n\x10GetPointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\t\"B\n\x11GetPointsResponse\x12\x1e\n\x06points\x18\x01 \x03(\x0b\x32\x0e.neumann.Point\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"6\n\x13\x44\x65letePointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\t\"6\n\x14\x44\x65letePointsResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x03\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x92\x01\n\x12QueryPointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\r\n\x05limit\x18\x03 \x01(\x05\x12\x13\n\x0b\x66ilter_json\x18\x04 \x01(\t\x12\x14\n\x0cwith_payload\x18\x05 \x01(\x08\x12\x0e\n\x06metric\x18\x06 \x01(\t\x12\x0e\n\x06req_id\x18\x0f \x01(\x04\">\n\x0bScoredPoint\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\x12\x14\n\x0cpayload_json\x18\x03 \x01(\t\"Z\n\x13QueryPointsResponse\x12$\n\x06result\x18\x01 \x03(\x0b\x32\x14.neumann.ScoredPoint\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\x0e\n\x06req_id\x18\x0f \x01(\x04\"H\n\x17QueryPointsBatchRequest\x12-\n\x08requests\x18\x01 \x03(\x0b\x32\x1b.neumann.QueryPointsRequest\"Z\n\x18QueryPointsBatchResponse\x12/\n\tresponses\x18\x01 \x03(\x0b\x32\x1c.neumann.QueryPointsResponse\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"K\n\x13ScrollPointsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\x05\x12\x11\n\toffset_id\x18\x03 \x01(\t\"]\n\x14ScrollPointsResponse\x12\x1e\n\x06points\x18\x01 \x03(\x0b\x32\x0e.neumann.Point\x12\x16\n\x0enext_offset_id\x18\x02 \x01(\t\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"`\n\x17\x43reateCollectionRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdimension\x18\x02 \x01(\x05\x12\x0e\n\x06metric\x18\x03 \x01(\t\x12\x14\n\x0cquantization\x18\x04 \x01(\t\"5\n\x18\x43reateCollectionResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"%\n\x15\x44ropCollectionRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"3\n\x16\x44ropCollectionResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x18\n\x16ListCollectionsRequest\"f\n\x0e\x43ollectionInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x02 \x01(\x03\x12\x11\n\tdimension\x18\x03 \x01(\x05\x12\x0e\n\x06metric\x18\x04 \x01(\t\x12\x14\n\x0cquantization\x18\x05 \x01(\t\"G\n\x17ListCollectionsResponse\x12,\n\x0b\x63ollections\x18\x01 \x03(\x0b\x32\x17.neumann.CollectionInfo\"=\n\tBlobChunk\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0c\x63ontent_type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"8\n\x12\x42lobUploadResponse\x12\x13\n\x0b\x61rtifact_id\x18\x01 \x01(\t\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"*\n\x13\x42lobDownloadRequest\x12\x13\n\x0b\x61rtifact_id\x18\x01 \x01(\t\"(\n\x11\x42lobDeleteRequest\x12\x13\n\x0b\x61rtifact_id\x18\x01 \x01(\t\"/\n\x12\x42lobDeleteResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"*\n\x13\x42lobMetadataRequest\x12\x13\n\x0b\x61rtifact_id\x18\x01 \x01(\t\"\xbc\x01\n\x0c\x41rtifactInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0c\n\x04size\x18\x03 \x01(\x03\x12\x10\n\x08\x63hecksum\x18\x04 \x01(\t\x12\x14\n\x0c\x63ontent_type\x18\x05 \x01(\t\x12\x0f\n\x07\x63reator\x18\x06 \x01(\t\x12\x0f\n\x07\x63reated\x18\x07 \x01(\x01\x12\x0c\n\x04tags\x18\x08 \x03(\t\x12\r\n\x05links\x18\t \x03(\t\x12\x0e\n\x06\x63hunks\x18\n \x01(\x05\x12\r\n\x05\x65rror\x18\x0b \x01(\t\"$\n\x14GetCollectionRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"S\n\x15GetCollectionResponse\x12+\n\ncollection\x18\x01 \x01(\x0b\x32\x17.neumann.CollectionInfo\x12\r\n\x05\x65rror\x18\x02 \x01(\t2\xde\x02\n\x0cQueryService\x12\x38\n\x07\x45xecute\x12\x15.neumann.QueryRequest\x1a\x16.neumann.QueryResponse\x12=\n\x0c\x45xecuteBatch\x12\x15.neumann.BatchRequest\x1a\x16.neumann.BatchResponse\x12I\n\x10\x45xecutePaginated\x12\x19.neumann.PaginatedRequest\x1a\x1a.neumann.PaginatedResponse\x12H\n\x0b\x43loseCursor\x12\x1b.neumann.CloseCursorRequest\x1a\x1c.neumann.CloseCursorResponse\x12@\n\rExecuteStream\x12\x15.neumann.QueryRequest\x1a\x16.neumann.QueryResponse0\x01\x32\x42\n\x06Health\x12\x38\n\x05\x43heck\x12\x16.neumann.HealthRequest\x1a\x17.neumann.HealthResponse2\x87\x04\n\rPointsService\x12\x45\n\x06Upsert\x12\x1c.neumann.UpsertPointsRequest\x1a\x1d.neumann.UpsertPointsResponse\x12<\n\x03Get\x12\x19.neumann.GetPointsRequest\x1a\x1a.neumann.GetPointsResponse\x12\x45\n\x06\x44\x65lete\x12\x1c.neumann.DeletePointsRequest\x1a\x1d.neumann.DeletePointsResponse\x12\x42\n\x05Query\x12\x1b.neumann.QueryPointsRequest\x1a\x1c.neumann.QueryPointsResponse\x12L\n\x0bQueryStream\x12\x1b.neumann.QueryPointsRequest\x1a\x1c.neumann.QueryPointsResponse(\x01\x30\x01\x12Q\n\nQueryBatch\x12 .neumann.QueryPointsBatchRequest\x1a!.neumann.QueryPointsBatchResponse\x12\x45\n\x06Scroll\x12\x1c.neumann.ScrollPointsRequest\x1a\x1d.neumann.ScrollPointsResponse2\x88\x03\n\x12\x43ollectionsService\x12M\n\x06\x43reate\x12 .neumann.CreateCollectionRequest\x1a!.neumann.CreateCollectionResponse\x12\x44\n\x03Get\x12\x1d.neumann.GetCollectionRequest\x1a\x1e.neumann.GetCollectionResponse\x12G\n\x04\x44rop\x12\x1e.neumann.DropCollectionRequest\x1a\x1f.neumann.DropCollectionResponse\x12I\n\x06\x44\x65lete\x12\x1e.neumann.DropCollectionRequest\x1a\x1f.neumann.DropCollectionResponse\x12I\n\x04List\x12\x1f.neumann.ListCollectionsRequest\x1a .neumann.ListCollectionsResponse2\x91\x02\n\x0b\x42lobService\x12;\n\x06Upload\x12\x12.neumann.BlobChunk\x1a\x1b.neumann.BlobUploadResponse(\x01\x12>\n\x08\x44ownload\x12\x1c.neumann.BlobDownloadRequest\x1a\x12.neumann.BlobChunk0\x01\x12\x41\n\x06\x44\x65lete\x12\x1a.neumann.BlobDeleteRequest\x1a\x1b.neumann.BlobDeleteResponse\x12\x42\n\x0bGetMetadata\x12\x1c.neumann.BlobMetadataRequest\x1a\x15.neumann.ArtifactInfob\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'neumann_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _QUERYREQUEST._serialized_start=26
  _QUERYREQUEST._serialized_end=75
  _ROW._serialized_start=77
  _ROW._serialized_end=96
  _HIT._serialized_start=98
  _HIT._serialized_end=131
  _QUERYRESPONSE._serialized_start=134
  _QUERYRESPONSE._serialized_end=286
  _BATCHREQUEST._serialized_start=288
  _BATCHREQUEST._serialized_end=342
  _BATCHRESPONSE._serialized_start=344
  _BATCHRESPONSE._serialized_end=400
  _PAGINATEDREQUEST._serialized_start=402
  _PAGINATEDREQUEST._serialized_end=470
  _PAGINATEDRESPONSE._serialized_start=472
  _PAGINATEDRESPONSE._serialized_end=555
  _CLOSECURSORREQUEST._serialized_start=557
  _CLOSECURSORREQUEST._serialized_end=593
  _CLOSECURSORRESPONSE._serialized_start=595
  _CLOSECURSORRESPONSE._serialized_end=632
  _HEALTHREQUEST._serialized_start=634
  _HEALTHREQUEST._serialized_end=649
  _HEALTHRESPONSE._serialized_start=651
  _HEALTHRESPONSE._serialized_end=729
  _POINT._serialized_start=731
  _POINT._serialized_end=788
  _UPSERTPOINTSREQUEST._serialized_start=790
  _UPSERTPOINTSREQUEST._serialized_end=863
  _UPSERTPOINTSRESPONSE._serialized_start=865
  _UPSERTPOINTSRESPONSE._serialized_end=920
  _GETPOINTSREQUEST._serialized_start=922
  _GETPOINTSREQUEST._serialized_end=973
  _GETPOINTSRESPONSE._serialized_start=975
  _GETPOINTSRESPONSE._serialized_end=1041
  _DELETEPOINTSREQUEST._serialized_start=1043
  _DELETEPOINTSREQUEST._serialized_end=1097
  _DELETEPOINTSRESPONSE._serialized_start=1099
  _DELETEPOINTSRESPONSE._serialized_end=1153
  _QUERYPOINTSREQUEST._serialized_start=1156
  _QUERYPOINTSREQUEST._serialized_end=1302
  _SCOREDPOINT._serialized_start=1304
  _SCOREDPOINT._serialized_end=1366
  _QUERYPOINTSRESPONSE._serialized_start=1368
  _QUERYPOINTSRESPONSE._serialized_end=1458
  _QUERYPOINTSBATCHREQUEST._serialized_start=1460
  _QUERYPOINTSBATCHREQUEST._serialized_end=1532
  _QUERYPOINTSBATCHRESPONSE._serialized_start=1534
  _QUERYPOINTSBATCHRESPONSE._serialized_end=1624
  _SCROLLPOINTSREQUEST._serialized_start=1626
  _SCROLLPOINTSREQUEST._serialized_end=1701
  _SCROLLPOINTSRESPONSE._serialized_start=1703
  _SCROLLPOINTSRESPONSE._serialized_end=1796
  _CREATECOLLECTIONREQUEST._serialized_start=1798
  _CREATECOLLECTIONREQUEST._serialized_end=1894
  _CREATECOLLECTIONRESPONSE._serialized_start=1896
  _CREATECOLLECTIONRESPONSE._serialized_end=1949
  _DROPCOLLECTIONREQUEST._serialized_start=1951
  _DROPCOLLECTIONREQUEST._serialized_end=1988
  _DROPCOLLECTIONRESPONSE._serialized_start=1990
  _DROPCOLLECTIONRESPONSE._serialized_end=2041
  _LISTCOLLECTIONSREQUEST._serialized_start=2043
  _LISTCOLLECTIONSREQUEST._serialized_end=2067
  _COLLECTIONINFO._serialized_start=2069
  _COLLECTIONINFO._serialized_end=2171
  _LISTCOLLECTIONSRESPONSE._serialized_start=2173
  _LISTCOLLECTIONSRESPONSE._serialized_end=2244
  _BLOBCHUNK._serialized_start=2246
  _BLOBCHUNK._serialized_end=2307
  _BLOBUPLOADRESPONSE._serialized_start=2309
  _BLOBUPLOADRESPONSE._serialized_end=2365
  _BLOBDOWNLOADREQUEST._serialized_start=2367
  _BLOBDOWNLOADREQUEST._serialized_end=2409
  _BLOBDELETEREQUEST._serialized_start=2411
  _BLOBDELETEREQUEST._serialized_end=2451
  _BLOBDELETERESPONSE._serialized_start=2453
  _BLOBDELETERESPONSE._serialized_end=2500
  _BLOBMETADATAREQUEST._serialized_start=2502
  _BLOBMETADATAREQUEST._serialized_end=2544
  _ARTIFACTINFO._serialized_start=2547
  _ARTIFACTINFO._serialized_end=2735
  _GETCOLLECTIONREQUEST._serialized_start=2737
  _GETCOLLECTIONREQUEST._serialized_end=2773
  _GETCOLLECTIONRESPONSE._serialized_start=2775
  _GETCOLLECTIONRESPONSE._serialized_end=2858
  _QUERYSERVICE._serialized_start=2861
  _QUERYSERVICE._serialized_end=3211
  _HEALTH._serialized_start=3213
  _HEALTH._serialized_end=3279
  _POINTSSERVICE._serialized_start=3282
  _POINTSSERVICE._serialized_end=3801
  _COLLECTIONSSERVICE._serialized_start=3804
  _COLLECTIONSSERVICE._serialized_end=4196
  _BLOBSERVICE._serialized_start=4199
  _BLOBSERVICE._serialized_end=4472
# @@protoc_insertion_point(module_scope)
